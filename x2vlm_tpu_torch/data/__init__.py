"""The host data plane of the launcher: tokenizer, masking, image decode and
transforms, the sharded line reader, batching, the pretraining streams and
the retrieval datasets (counterparts of x2vlm_tpu/data/)."""
