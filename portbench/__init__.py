"""The benchmark of the PyTorch and CUDA port (``iterativelqr_tpu_torch``).

``python3 -m portbench.run`` runs one cell of ``BENCHMARK.json`` once;
``python3 -m portbench.control`` reads the comparison's control and
faults.  ``port.py`` is the only module that imports the program.
"""
