"""The launcher's tasks: the mixed-stream pretraining loop, the fine-tune
epoch loop, the two-stage retrieval evaluation, grounding prediction and
classification accuracy, and the merge of the ranks' eval results."""
