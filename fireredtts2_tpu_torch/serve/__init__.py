"""The serving front end: the REST/WebSocket/OpenAI server and its ops
modules (counterpart of ``fireredtts2_tpu/serve/``)."""
