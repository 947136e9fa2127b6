"""The benchmark of ``corrla_rs_tpu_torch``, the PyTorch and CUDA port, on
NVIDIA H100s. ``run.py`` runs one cell once; ``harness`` holds the run;
``BENCHMARK.json`` at the root of the repo names the cells, and each
configuration, traffic mix, model and metric is a file of its own here."""
