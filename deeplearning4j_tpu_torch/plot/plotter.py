"""Weight/activation plotting + filter rendering
(the port's copy of ``deeplearning4j_tpu/plot/plotter.py``).

≙ reference plot/NeuralNetPlotter.java:34 (which shells out to bundled
matplotlib scripts — resources/scripts/plot.py) and FilterRenderer.java.
Python is idiomatic here already, so matplotlib is called directly
(headless Agg backend).  ≙ NeuralNetPlotterIterationListener hooks this
into the optimizer loop.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from deeplearning4j_tpu_torch.optimize.api import IterationListener


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class NeuralNetPlotter:
    def __init__(self, out_dir: str | Path = "plots"):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)

    def plot_weight_histograms(self, params: dict, name: str = "weights") -> Path:
        """Histogram grid of every param tensor (≙ plotWeights/plot.py)."""
        plt = _plt()
        items = list(params.items())
        cols = min(len(items), 3)
        rows_n = math.ceil(len(items) / cols)
        fig, axes = plt.subplots(rows_n, cols, figsize=(4 * cols, 3 * rows_n), squeeze=False)
        for ax in axes.flat:
            ax.axis("off")
        for ax, (key, w) in zip(axes.flat, items):
            ax.axis("on")
            ax.hist(np.asarray(w).ravel(), bins=50)
            ax.set_title(key)
        out = self.out_dir / f"{name}.png"
        fig.tight_layout()
        fig.savefig(out)
        plt.close(fig)
        return out

    def render_filters(
        self, w: np.ndarray, name: str = "filters", patch_shape: tuple[int, int] | None = None
    ) -> Path:
        """Grid image of learned filters (≙ FilterRenderer.java:541).

        w: (n_in, n_out) dense weights (columns become patches) or
        (kh, kw, c_in, c_out) conv kernels.
        """
        plt = _plt()
        w = np.asarray(w)
        if w.ndim == 4:
            patches = [w[:, :, 0, i] for i in range(w.shape[-1])]
        else:
            side = patch_shape or (
                int(math.isqrt(w.shape[0])), int(math.isqrt(w.shape[0]))
            )
            patches = [w[: side[0] * side[1], i].reshape(side) for i in range(w.shape[1])]
        n = len(patches)
        cols = math.ceil(math.sqrt(n))
        rows_n = math.ceil(n / cols)
        fig, axes = plt.subplots(rows_n, cols, figsize=(cols, rows_n), squeeze=False)
        for ax in axes.flat:
            ax.axis("off")
        for ax, p in zip(axes.flat, patches):
            ax.imshow(p, cmap="gray")
        out = self.out_dir / f"{name}.png"
        fig.tight_layout()
        fig.savefig(out, dpi=120)
        plt.close(fig)
        return out

    def plot_activations(self, activations: np.ndarray, name: str = "activations") -> Path:
        plt = _plt()
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.imshow(np.asarray(activations), aspect="auto", cmap="viridis")
        ax.set_xlabel("unit")
        ax.set_ylabel("example")
        out = self.out_dir / f"{name}.png"
        fig.savefig(out)
        plt.close(fig)
        return out


class PlotterIterationListener(IterationListener):
    """≙ NeuralNetPlotterIterationListener.java:70 — render every N iters."""

    def __init__(self, get_params, out_dir="plots", every: int = 50):
        self.get_params = get_params
        self.plotter = NeuralNetPlotter(out_dir)
        self.every = every

    def iteration_done(self, info: dict) -> None:
        i = info["iteration"]
        if i % self.every == 0:
            self.plotter.plot_weight_histograms(
                self.get_params(), name=f"weights_iter{i}"
            )


# self-contained scatter page: pan/zoom canvas, hover labels, no external
# assets (the reference ships a jquery+highcharts bundle under
# deeplearning4j-nlp/src/main/resources/assets; offline here, so inline JS)
_TSNE_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>t-SNE — deeplearning4j_tpu</title>
<style>
 body{margin:0;font:13px system-ui,sans-serif;background:#111;color:#ddd}
 #hud{position:fixed;top:8px;left:12px;pointer-events:none}
 canvas{display:block;cursor:grab}
</style></head><body>
<div id="hud">t-SNE render — drag to pan, wheel to zoom, hover for words</div>
<canvas id="c"></canvas>
<script>
const cv=document.getElementById('c'),cx=cv.getContext('2d');
let pts=[],tx=0,ty=0,scale=1,drag=null,hover=-1;
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw()}
function sx(p){return (p.x-mid.x)*base*scale+cv.width/2+tx}
function sy(p){return (p.y-mid.y)*base*scale+cv.height/2+ty}
let mid={x:0,y:0},base=1;
function fit(){
 if(!pts.length)return;
 const xs=pts.map(p=>p.x),ys=pts.map(p=>p.y);
 const w=Math.max(...xs)-Math.min(...xs)||1,h=Math.max(...ys)-Math.min(...ys)||1;
 mid={x:(Math.max(...xs)+Math.min(...xs))/2,y:(Math.max(...ys)+Math.min(...ys))/2};
 base=0.9*Math.min(cv.width/w,cv.height/h);
}
function draw(){
 cx.clearRect(0,0,cv.width,cv.height);
 pts.forEach((p,i)=>{
  cx.fillStyle=i===hover?'#ff5':'#6cf';
  cx.beginPath();cx.arc(sx(p),sy(p),i===hover?5:2.5,0,7);cx.fill();
  if(scale>2.5||i===hover){cx.fillStyle=i===hover?'#ff5':'#9ab';
   cx.fillText(p.word,sx(p)+6,sy(p)+4);}
 });
}
cv.onmousedown=e=>{drag={x:e.clientX-tx,y:e.clientY-ty};cv.style.cursor='grabbing'};
onmouseup=()=>{drag=null;cv.style.cursor='grab'};
onmousemove=e=>{
 if(drag){tx=e.clientX-drag.x;ty=e.clientY-drag.y;draw();return}
 let best=-1,bd=144;
 pts.forEach((p,i)=>{const d=(sx(p)-e.clientX)**2+(sy(p)-e.clientY)**2;
  if(d<bd){bd=d;best=i}});
 if(best!==hover){hover=best;draw()}
};
onwheel=e=>{scale*=e.deltaY<0?1.15:1/1.15;draw()};
onresize=resize;
fetch('/coords').then(r=>r.json()).then(d=>{pts=d;resize();fit();draw()});
resize();
</script></body></html>"""


def serve_tsne(words: list[str], coords: np.ndarray, port: int = 0) -> int:
    """Browsable t-SNE render server.

    ≙ the reference's dropwizard render webapp (plot/dropwizard/
    RenderApplication.java:53 serving ApiResource coords + a JS scatter
    under nlp resources/assets): ``GET /`` returns a self-contained
    HTML/canvas scatter page (pan/zoom/hover), ``GET /coords`` the
    [{word, x, y}] JSON the page fetches."""
    import json
    import threading
    from http.server import ThreadingHTTPServer

    from deeplearning4j_tpu_torch.utils.httpjson import QuietHandler, send_body

    payload = json.dumps(
        [
            {"word": w, "x": float(x), "y": float(y)}
            for w, (x, y) in zip(words, np.asarray(coords))
        ]
    ).encode()
    page = _TSNE_PAGE.encode()

    class Handler(QuietHandler):
        def do_GET(self):  # noqa: N802
            if self.path in ("/", "/index.html"):
                send_body(self, 200, page, "text/html; charset=utf-8")
            elif self.path in ("/coords", "/api/coords"):
                # /api/coords matches the reference's dropwizard
                # ApiResource path; /coords is what the bundled page uses
                send_body(self, 200, payload, "application/json")
            else:
                # unknown paths (favicon.ico, typos) must not ship the
                # whole coords payload
                send_body(self, 404, b"{}", "application/json")

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server.server_address[1]
