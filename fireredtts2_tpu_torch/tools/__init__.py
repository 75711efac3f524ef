"""Probe tools of the port, on the card: the counterparts of the JAX
package's ``tools/probe_depth_kernel.py``, ``tools/probe_dequant.py``,
``tools/probe_s8_chunked.py`` and ``tools/_ablate_depth_kernel.py``. Each
runs as ``python -m fireredtts2_tpu_torch.tools.<name>`` on CUDA and raises
without a card; the engine never imports them."""
