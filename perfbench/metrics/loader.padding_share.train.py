"""% of the traced steps' edge slots that hold no real edge: the padding
that ``GraphLoader``'s bucketed capacities give a batch (loader layer)."""


def read(run):
    slots = sum(u.get("slots", 0) for u in run.units)
    if run.unit != "step" or not slots:
        return None
    return 100.0 * (slots - sum(u["E"] for u in run.units)) / slots
