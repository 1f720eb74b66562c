"""Part palette, label ids and carve presets — re-exported from
``pbr3d.config``, which imports only numpy (``import pbr3d`` pulls in no jax).
Presets and palettes are therefore the very same objects in both packages."""

from pbr3d.config import *  # noqa: F401,F403
