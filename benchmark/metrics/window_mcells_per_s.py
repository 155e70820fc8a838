"""window_mcells_per_s (Mcells/s): cells x steps of the traced window's call
over the host time of that call (``ctx["window_s"]``), the end-to-end rate
as the traced run reads it.  It stands per layer in a cell whose loop the
host paces, where the untraced rate swings with the shared host too widely
for a bound; under the profiler the window is shorter and slower than an
untraced one, so it reads below ``mcells_per_s``."""


def read(trace: dict, ctx: dict) -> float | None:
    window_s = ctx.get("window_s")
    if not window_s or window_s <= 0 or ctx["steps"] <= 0:
        return None
    return ctx["cells"] * ctx["steps"] / window_s / 1e6
