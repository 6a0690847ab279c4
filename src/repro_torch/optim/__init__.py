"""Sharded AdamW on the fp32 master shards."""
