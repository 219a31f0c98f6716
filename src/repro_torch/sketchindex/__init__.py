"""Index construction helpers shared with the distributed build."""
