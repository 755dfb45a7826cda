"""Worker process of the two-process test (test_torch_multihost.py).

Each process brings 4 entries of the CPU; the ('tiles', 'spp') multihost
mesh lays tiles across the two processes and spp within each, so
``gather_image`` must assemble the full image through the gloo
``all_gather`` and the directory checkpoint is written by both ranks.

Run: python tests/_torch_multihost_worker.py <rank> <port> <out_dir>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

H, W = 8, 16


def main() -> None:
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                         world_size=2, rank=rank)
    try:
        run(rank, out)
    finally:
        torch.distributed.destroy_process_group()
    print(f"TORCH_MULTIHOST_OK {rank}", flush=True)


def run(rank: int, out: str) -> None:
    from tpu_pathtracer_torch import Renderer, RenderConfig
    from tpu_pathtracer_torch.io.checkpoint import load_checkpoint
    from tpu_pathtracer_torch.parallel.multihost import make_multihost_mesh

    mesh = make_multihost_mesh(n_spp=2, devices=[torch.device("cpu")] * 4)
    assert mesh.shape == {"tiles": 4, "spp": 2}
    # every spp group lies within one process; tiles 0-1 are rank 0's
    assert mesh.ranks == ((0, 0), (0, 0), (1, 1), (1, 1)), mesh.ranks

    cfg = RenderConfig(samples_per_frame=2, max_path_length=2)
    r = Renderer("cornellbox", W, H, cfg, mesh=mesh)
    r.run(2)
    mine = [t for t, x in enumerate(r.state.accum.tiles) if x is not None]
    assert mine == [2 * rank, 2 * rank + 1], mine
    img = r.image()  # the gloo all_gather of both processes' tile rows
    assert img.shape == (H, W, 3)

    ref = Renderer("cornellbox", W, H, cfg, device="cpu")
    ref.run(2)
    np.testing.assert_allclose(img, ref.image(), rtol=0, atol=2e-6)

    ck = os.path.join(out, "ck")
    r.save_checkpoint(ck)  # each rank its own tiles, rank 0 the manifest
    st = load_checkpoint(ck)
    np.testing.assert_array_equal(st.accum.numpy(), img)
    assert st.frame_index == 2

    r.save_checkpoint(ck + ".npz")  # the full image, gathered; rank 0 writes
    torch.distributed.barrier()
    np.testing.assert_array_equal(load_checkpoint(ck + ".npz").accum.numpy(), img)

    r.load_checkpoint(ck)  # resharded onto the live mesh
    r.run(1)
    ref.run(1)
    np.testing.assert_allclose(r.image(), ref.image(), rtol=0, atol=2e-6)


if __name__ == "__main__":
    main()
