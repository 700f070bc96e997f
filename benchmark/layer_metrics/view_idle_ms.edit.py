"""view_idle_ms.edit: milliseconds per traced edited view in which the card
sat idle while the host was inside the program's `edit.view` span
(dmnerf_torch/edit/runner.py::_prefetch_map under eval_views: the view's
rays and padding, its chunks' launches, the label reductions and the start
of its copy), per `edit.view` span (the view launched ahead included);
benchmark/spans.py."""

from benchmark import spans


def view_spans(trace) -> int:
    """The `edit.view` spans of the trace, one a view dispatched."""
    return sum(1 for e in trace.get("traceEvents", []) if e.get("ph") == "X"
               and e.get("name") == "edit.view" and e.get("cat", "").lower() == "user_annotation")


def read(ctx):
    t = ctx.get("traced")
    if not t or not t.get("views"):
        return None
    ix = spans.index(t)
    views, idle = view_spans(t["trace"]), spans.idle_ms(ix, "edit.view")
    if not views or idle is None:
        return None
    return idle / views
