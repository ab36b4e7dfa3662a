"""Bloom filter: geometry and build (``ops``), the fused multi-table
probe kernel and its twin (``bloom``), and the numpy oracle (``ref``)."""
