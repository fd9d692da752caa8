"""Model summary text — the run's record of the model it trained.

The counterpart of ``p_div_gnn_tpu/models/summary.py:20``: a header (class
name and the config fields that shape the computation), one row per
parameter with its flax path, shape and count, in the flax tree's sorted
order, and the total count — the same text the JAX package renders for the
same model.
"""

from __future__ import annotations

from torch import nn

from p_div_gnn_tpu_torch.models.params import jax_path


def model_summary(model: nn.Module) -> str:
    """Render a per-parameter table of ``model`` with a total count."""
    rows = []
    for name, p in model.named_parameters():
        shape = tuple(int(s) for s in p.shape)
        rows.append((jax_path(name)[1:], shape, p.numel()))
    rows.sort(key=lambda r: r[0])
    total = sum(r[2] for r in rows)

    cfg = [f"{field}={getattr(model, field)}"
           for field in ("latent_size", "message_passing_steps", "scatter_impl", "stream_dtype")
           if hasattr(model, field)]
    name = type(model).__name__
    header = f"{name} ({', '.join(cfg)})" if cfg else name

    paths = ["/".join(r[0]) for r in rows]
    w = max((len(p) for p in paths), default=10)
    lines = [header, "=" * len(header),
             f"{'Parameter':<{w}}  {'Shape':>16}  {'Count':>10}",
             "-" * (w + 30)]
    for path, (_, shape, count) in zip(paths, rows):
        lines.append(f"{path:<{w}}  {str(shape):>16}  {count:>10,}")
    lines.append("-" * (w + 30))
    lines.append(f"Total params: {total:,}")
    return "\n".join(lines)
