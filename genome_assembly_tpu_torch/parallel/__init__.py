"""Multi-device counting and dBG compaction over a mesh of shards."""
