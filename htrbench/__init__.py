"""htrbench: the benchmark of ``htr_vt_torch``, the PyTorch and CUDA port.

One run measures one cell of ``BENCHMARK.json`` once::

    python3 -m htrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one model configuration, traffic mix, window
driver, per-layer metric or cell's correctness limits sits in a file of its
own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model configuration as it is run;
- ``traffic/<traffic>.json``: the window driver to use and its parameters;
- ``drivers/<driver>.py``: one module per kind of window;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``limits/<cell>.json``: the limits of the numbers that decide ``correct``;
- ``reference/``: the plain reference (plain PyTorch, nothing of the port).

The yardstick (lines, length mixes, FLOP and byte counts, peaks, the trace
reduction) lives here too, so that a change to the program cannot move it.
"""
