"""Evaluation suites: intra-method (notebook 4) and inter-method (notebook 5)."""

from pbr3d_torch.eval import inter, intra

__all__ = ["inter", "intra"]
