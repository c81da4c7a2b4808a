"""rdcfes_tpu_torch — the PyTorch + CUDA port of rdcfes_tpu for NVIDIA Hopper.

The JAX package `rdcfes_tpu` is the reference; this package mirrors its
module paths (`rdcfes_tpu/X/Y.py` -> `rdcfes_tpu_torch/X/Y.py`) and its
channel-first layouts at public functions: u (V, N), ue (V, K, E),
u_qp (V, Q, E).

Differences from the reference, by design:
  * plain functions on tensors with an explicit device and dtype; there is
    no global default dtype and importing the package sets no state;
  * PyTorch runs eagerly, so the reference's TPU compile workarounds (jit,
    scan segments, tables passed as jit arguments, channel padding, E_pad,
    the Beneš gather routing, hi/lo and df64 paired-f32 arithmetic) have no
    counterpart: Hopper has indexed loads and native f64;
  * the element kernels of the main path are hand-written CUDA C++
    (`csrc/`, bound in `fem/kernels.py`), each with a plain PyTorch version
    that runs on CPU tensors.

The package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
