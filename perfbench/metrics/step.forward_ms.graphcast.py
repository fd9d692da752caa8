"""``step.forward_ms.train``'s reader, for the cell ``train.graphcast.fp32``: the
accepted entry's cells are held to ``train.fp32``
(``tests/test_perfbench_program_spans.py``), so GraphCast's cell reports
the same reading under this name."""

from perfbench.harness.registry import metric_reader

read = metric_reader("step.forward_ms.train").read
