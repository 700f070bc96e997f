"""exchange_ms.edit: host milliseconds per traced edited view inside the
program's `edit.exchange` spans (dmnerf_torch/edit/manipulator.py::
manipulate_chunk: both exchanger calls of each chunk and the re-composite
after the first), per `edit.view` span (edit/runner.py, one a view,
the view launched ahead included); benchmark/spans.py."""

from benchmark import spans
from benchmark.trace_summary import _length


def view_spans(trace) -> int:
    """The `edit.view` spans of the trace, one a view dispatched."""
    return sum(1 for e in trace.get("traceEvents", []) if e.get("ph") == "X"
               and e.get("name") == "edit.view" and e.get("cat", "").lower() == "user_annotation")


def read(ctx):
    t = ctx.get("traced")
    if not t or not t.get("views"):
        return None
    ix = spans.index(t)
    views, iv = view_spans(t["trace"]), ix["spans"].get("edit.exchange")
    if not views or not iv or ix["idle"] is None:
        return None
    return _length(iv) / 1e3 / views
