"""Benchmarks of the PyTorch/CUDA port: the paper's tables and figures
over ``repro_torch.core`` and the kernel micro-benchmark on the card.

Counterpart of ``benchmarks/``; run as ``python -m benchmarks_torch.run``
with ``src`` on ``PYTHONPATH``.  Artifacts go to ``artifacts/bench_torch/``.
"""
