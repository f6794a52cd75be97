"""Weight loading: the GGUF reader / writer and the Q4_0 GGUF loader
(ports of ``voxtral_tpu/loaders/{gguf,names,gguf_loader}.py``)."""
