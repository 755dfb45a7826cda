"""tpu_pathtracer_torch: the renderer of ``tpu_pathtracer`` ported to PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

``tpu_pathtracer`` (JAX) stays the reference; this package imports no JAX.
"""

from .config import RenderConfig  # noqa: F401
from .renderer import Renderer  # noqa: F401
