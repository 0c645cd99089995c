"""The paper's application suite and its figure/table driver, the
counterpart of the reference's repo-root ``benchmarks/`` package.

* :mod:`repro_torch.suite.apps` — the 13 Table-2 applications, registered
  as ``app/<name>`` workloads;
* :mod:`repro_torch.suite.figures` — one function per paper figure/table;
* :mod:`repro_torch.suite.run` — the driver
  (``python -m repro_torch.suite.run``), one CSV per benchmark and a
  ``summary.json``.
"""
