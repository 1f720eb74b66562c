"""The benchmark of the PyTorch port (``pbr3d_torch``): one cell of
``BENCHMARK.json`` a run, through ``portbench/run.py``."""
