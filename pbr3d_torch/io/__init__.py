"""Artifact & dataset IO (host side), as in ``pbr3d.io``."""
