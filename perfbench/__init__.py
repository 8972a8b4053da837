"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
cell a run, ``python3 perfbench/run.py`` (see ``run.py``)."""
