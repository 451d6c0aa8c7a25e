"""The inference scheduler (EPP): its plugin pipeline, datastore, prefix
index and HTTP gateway (port of ``llm_d_tpu.epp``)."""
