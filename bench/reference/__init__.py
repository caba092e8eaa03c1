"""The plain reference: each architecture's model (``<arch_type>.py``,
found by name; ``dense.py``), its loss and gradients, AdamW, the DiPaCo
outer step, and the comparisons that decide ``correct``.

Plain PyTorch in f32 with TF32 off (``precise()``), or with every matrix
product's inputs rounded to float8 e4m3 (the control).  It imports
nothing of ``repro_torch``, ``repro`` or ``jax``, and takes from the
program only the outputs it judges and the routing it is fed (the
training shards' assignment, the serving router's centroids: PERF.md
says why).
"""
