"""Command-line tools of the port: the fused step (``megastep``) and the
kernel probes (``kernel_probe``), counterparts of the JAX package's
``tools/pallas_megastep_experiment.py`` and ``tools/mosaic_probe.py``."""
