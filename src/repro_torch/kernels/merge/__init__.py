"""Sorted-run merge: co-rank planning and the k-way newest-wins
tournament (``ops``), the age-carrying merge-path kernel and its twin
(``merge``), and the numpy oracle (``ref``)."""
