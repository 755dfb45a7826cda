"""The multi-process path of tpu_pathtracer_torch.parallel with two real
processes joined by torch.distributed (gloo on 127.0.0.1): the counterpart
of tests/test_multihost_dcn.py.  Each worker (tests/_torch_multihost_worker.py)
brings 4 CPU entries to a (4, 2) mesh whose tiles span both processes,
checks that ``gather_image`` equals the single-process render (atol 2e-6,
the rounding of the sum over 'spp') and writes a directory checkpoint with
the other rank, and an npz checkpoint of the gathered image; this test then
loads both."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tpu_pathtracer_torch import Renderer, RenderConfig
from tpu_pathtracer_torch.io.checkpoint import load_checkpoint

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_torch_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gather_and_checkpoint(tmp_path):
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, _WORKER, str(rank), port, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    outs = []
    try:
        for rank, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=240)[0])
            except subprocess.TimeoutExpired:
                pytest.fail(f"worker {rank} timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out}"
        assert f"TORCH_MULTIHOST_OK {rank}" in out, out

    st = load_checkpoint(str(tmp_path / "ck"))
    assert st.frame_index == 2
    assert sorted(os.listdir(tmp_path / "ck")) == [f"accum.{k}.npy" for k in range(4)] + [
        "manifest.json"]
    np.testing.assert_array_equal(load_checkpoint(str(tmp_path / "ck.npz")).accum.numpy(),
                                  st.accum.numpy())
    ref = Renderer("cornellbox", 16, 8, RenderConfig(samples_per_frame=2, max_path_length=2),
                   device="cpu")
    ref.run(2)
    np.testing.assert_allclose(st.accum.numpy(), ref.image(), rtol=0, atol=2e-6)
