"""Hand-written CUDA kernels of the storage path, each with its plain
PyTorch twin: ``bloom`` (the fused multi-table probe behind every point
read) and ``merge`` (the age-carrying merge-path merge behind every merge
window and multi-run scan).  ``cuda`` builds and binds them."""
