"""The benchmark of ``optical_flow_tpu_torch`` (the PyTorch and CUDA port)
on one H100: live and recorded 1080^2 gesture tracking, driven by the data
in ``BENCHMARK.json`` and the files under this folder. ``run.py`` is the
command; ``reference/`` is the plain reference the results are held to.
It imports nothing of JAX or of the JAX package.
"""
