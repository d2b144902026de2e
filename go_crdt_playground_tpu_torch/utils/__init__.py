"""Host runtime: the δ wire codec, the write-ahead log, checkpoints."""
