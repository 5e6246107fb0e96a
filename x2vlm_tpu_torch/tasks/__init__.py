"""The launcher's tasks: the mixed-stream pretraining loop, the fine-tune
epoch loop and the two-stage retrieval evaluation."""
