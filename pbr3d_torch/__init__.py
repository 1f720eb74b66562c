"""pbr3d_torch — the PyTorch/CUDA port of pbr3d, for one NVIDIA H100.

Mirrors ``pbr3d``'s layout and names so each module's counterpart is easy to
find.  The JAX package stays the reference: this package never imports jax,
and its tests run both on the same inputs.

Conventions: plain functions on tensors; every public entry that takes host
data has an explicit ``device`` argument (there is no default device); label
grids stay uint8 and integer work is bit-exact against ``pbr3d``.
"""

from pbr3d_torch import config

__version__ = "0.1.0"

__all__ = ["config", "__version__"]
