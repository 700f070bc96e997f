"""view_idle_ms.render: milliseconds per traced view in which the card sat
idle while the host was inside the program's `render.view` span
(dmnerf_torch/eval/renderer.py::make_image_renderer's render_im_dev: the
view's rays, the launches of its chunks, the label reduction and the start
of its copy to the host); benchmark/spans.py."""

from benchmark import spans


def read(ctx):
    return spans.per(ctx, "views", spans.idle_ms, "render.view")
