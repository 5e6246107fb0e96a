"""Host-side core of the launcher: configs, their key registry, file access
(local, hdfs://, gs://) and the process group of a multi-GPU run."""
