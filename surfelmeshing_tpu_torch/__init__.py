"""surfelmeshing_tpu_torch: the PyTorch/CUDA port of surfelmeshing_tpu.

The frame step (depth preprocessing + 8-phase surfel fusion) runs as plain
PyTorch tensor code; the measurement-blending stencil, the one Pallas kernel
of the JAX package on that path, is a hand-written CUDA kernel
(csrc/blend.cu) built for sm_90a at first use.

The JAX package stays the reference and the port imports nothing of it,
nor jax: the host layer it shares with the JAX package (config, io,
utils, eval.mesh_accuracy, meshing and the native mesher) is the port's
own copy, under the same module names.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """The explicit device a state or pipeline lives on.

    Raises when CUDA is asked for and not available; never substitutes the
    CPU for a missing GPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
