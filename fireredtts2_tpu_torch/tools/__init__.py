"""Tools of the port: the probe tools, on the card (the counterparts of the
JAX package's ``tools/probe_depth_kernel.py``, ``tools/probe_dequant.py``,
``tools/probe_s8_chunked.py`` and ``tools/_ablate_depth_kernel.py``; each
runs as ``python -m fireredtts2_tpu_torch.tools.<name>`` on CUDA and raises
without a card), the kernel comparison and sweep tools, and
``ref_checkpoint`` (reference-layout pickles written from the port's
trees, for the convert drill's card run and the tests). The engine never
imports them."""
