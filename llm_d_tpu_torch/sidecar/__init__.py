"""The routing sidecar in front of a decode pod (port of
``llm_d_tpu.sidecar``)."""
