"""Host-side analysis: the results comparison (``compare``), its figures
(``plots``) and the GNN-vs-FEM wall-time benchmark (``benchmark``)."""
