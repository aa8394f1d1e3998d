"""Browser GUI (reference layer 6, gui.py — panel there; stdlib http.server
here, panel not being a dependency).

The port of biem_helmholtz_sphere_tpu.gui.  Feature parity with the
reference's widget surface (gui.py:30-254):
dimension/branching-type selection (standard / standard_prime / hopf /
random / custom string), backend device + dtype (the CUDA cards and the
CPU; the reference enumerates via __array_namespace_info__(),
gui.py:144-159), wavenumber (complex), eta, n_end (capped by max_n_end
against available memory, reference gui.py:189-199), inner/outer kind,
force_matrix toggle, per-sphere rows (alpha, beta, radius, center) with
add/remove buttons (reference gui.py:229-254), reactive recompute on any
widget change via an in-place fetch to the /compute fragment endpoint
(the stdlib equivalent of the reference's websocket push, gui.py:256-338)
with a progress indicator and notification-style error panel (gui.py:401-412),
near-field + far-field plots side by side, time-phase / animation
control (reference's plot_biem time animation), per-ball plot selection,
and SVG/PNG/JPG download of the figure.
"""

import base64
import html
import io
import logging
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs


__all__ = ["serve", "servable"]

log = logging.getLogger(__name__)

# ThreadingHTTPServer runs each request on its own thread; solves are
# serialized through this lock so two reactive /compute requests never
# solve concurrently on the one card (and matplotlib's pyplot
# state machine is never entered from two threads).  The reference
# serializes naturally through panel's event loop (gui.py:410-412).
_compute_lock = threading.Lock()
# Server-side staleness: the newest /compute sequence number seen per
# client.  A request that was queued behind the lock but superseded by a
# newer one from the same client is dropped without touching the
# device.  Guarded by _seq_lock (NOT by _compute_lock: a newer request
# must be able to register its seq while an older solve holds the
# compute lock).
_seq_lock = threading.Lock()
_latest_seq = {}


def _locked_solve_and_plot(form, seq=None, client=""):
    """Run _solve_and_plot under the global compute lock.

    When ``seq`` is given (reactive /compute requests), returns ``None``
    without computing if a newer request from the same ``client``
    registered itself while this one waited for the lock — the
    server-side counterpart of the client's ``window.__seq`` guard.
    """
    if seq is not None:
        with _seq_lock:
            _latest_seq[client] = max(_latest_seq.get(client, 0), seq)
    with _compute_lock:
        if seq is not None:
            with _seq_lock:
                if seq < _latest_seq.get(client, 0):
                    return None
        return _solve_and_plot(form)

_DEFAULT_SPHERES = ["1+0j, 0+0j, 1.0, 0 2 0", "1+0j, 0+0j, 1.0, 0 -2 0"]

_PAGE = """<!DOCTYPE html>
<html><head><title>biem-helmholtz-sphere-tpu-torch</title>
<style>
body {{ font-family: sans-serif; margin: 2em; max-width: 1100px; }}
fieldset {{ margin-bottom: 1em; }} label {{ margin-right: 1em; }}
input.sphere {{ width: 60%; font-family: monospace; }}
img {{ max-width: 48%; }} .err {{ color: #b00; white-space: pre-wrap; }}
#progress {{ color: #06c; font-weight: bold; display: none; }}
</style>
<script>
function addRow(val) {{
  var list = document.getElementById('spherelist');
  var div = document.createElement('div');
  div.innerHTML = '<input class="sphere" name="sphere" value="' + (val || '1+0j, 0+0j, 1.0, 0 0 0')
    + '"> <button type="button" onclick="this.parentNode.remove()">&minus;</button>';
  list.appendChild(div);
}}
function showProgress() {{
  document.getElementById('progress').style.display = 'inline';
  return true;
}}
// Reactive recompute (reference gui.py:256-338 recomputes server-side
// on ANY widget change and pushes the new panes over its websocket):
// any form change triggers, after a short debounce, a fetch() POST to
// the /compute fragment endpoint and swaps the result panes in place —
// no page reload, the form keeps focus/scroll state, like the
// reference's push.  The "reactive" checkbox opts out; the Compute
// button still full-page-POSTs so the GUI works without JS.
document.addEventListener('DOMContentLoaded', function () {{
  var form = document.querySelector('form');
  form.addEventListener('change', function (e) {{
    var r = document.getElementById('reactive');
    if (!r || !r.checked || e.target === r) return;
    clearTimeout(window.__autoT);
    window.__autoT = setTimeout(function () {{
      showProgress();
      var seq = (window.__seq = (window.__seq || 0) + 1);
      // abort the superseded in-flight fetch; the server additionally
      // drops stale queued requests by their __seq before solving
      if (window.__ctl) window.__ctl.abort();
      var ctl = (window.__ctl = new AbortController());
      var body = new URLSearchParams(new FormData(form));
      body.append('__seq', seq);
      body.append('__cid', window.__cid = window.__cid || String(Math.random()).slice(2));
      fetch('/compute', {{
        method: 'POST',
        headers: {{'Content-Type': 'application/x-www-form-urlencoded'}},
        body: body.toString(),
        signal: ctl.signal,
      }}).then(function (resp) {{
          if (resp.status === 204) return null;  // server dropped a stale request
          return resp.text();
        }})
        .then(function (frag) {{
          if (seq !== window.__seq) return;  // a newer change superseded us
          if (frag !== null) document.getElementById('result').innerHTML = frag;
          document.getElementById('progress').style.display = 'none';
        }})
        .catch(function () {{
          if (seq !== window.__seq) return;  // keep the spinner for the live request
          document.getElementById('progress').style.display = 'none';
        }});
    }}, 400);
  }});
}});
</script>
</head><body>
<h2>biem-helmholtz-sphere-tpu-torch</h2>
<form method="post" action="/" onsubmit="return showProgress()">
<fieldset><legend>Coordinates</legend>
<label>type
<select name="ctype">
<option value="standard" {standard}>standard</option>
<option value="standard_prime" {standard_prime}>standard_prime</option>
<option value="hopf" {hopf}>hopf</option>
<option value="random" {random}>random</option>
<option value="custom" {custom}>custom</option>
</select></label>
<label>dimension <input name="dim" value="{dim}" size="2"></label>
<label>custom branching string <input name="btype" value="{btype}" size="10"></label>
</fieldset>
<fieldset><legend>Backend</legend>
<label>device <select name="device">{device_options}</select></label>
<label>dtype <select name="dtype">{dtype_options}</select></label>
</fieldset>
<fieldset><legend>Calculation</legend>
<label>k (complex ok) <input name="k" value="{k}" size="10"></label>
<label>eta <input name="eta" value="{eta}" size="6"></label>
<label>n_end <input name="n_end" value="{n_end}" size="4"> (max for this memory: {n_end_cap})</label>
<label>kind <select name="kind"><option {outer}>outer</option><option {inner}>inner</option></select></label>
<label>force_matrix <input type="checkbox" name="force_matrix" {force_matrix}></label>
</fieldset>
<fieldset><legend>Spheres (alpha, beta, radius, center coords)</legend>
<div id="spherelist">{sphere_rows}</div>
<button type="button" onclick="addRow()">+ add sphere</button>
</fieldset>
<fieldset><legend>Plot</legend>
<label>plane axes <input name="axes" value="{axes}" size="4"></label>
<label>extent <input name="lim" value="{lim}" size="5"></label>
<label>time t <input name="t" value="{t}" size="4"></label>
<label>animate <input type="checkbox" name="animate" {animate}></label>
<label>balls (blank = all) <input name="balls" value="{balls}" size="8"></label>
<label>signed log <input type="checkbox" name="slog" {slog}></label>
<label>format <select name="fmt"><option>png</option><option>svg</option><option>jpg</option></select></label>
</fieldset>
<button type="submit">Compute</button>
<label>reactive <input type="checkbox" id="reactive" name="reactive" {reactive}></label>
<span id="progress">computing&hellip;</span>
</form>
<div id="result">
<div>{status}</div>
<div>{images}</div>
</div>
</body></html>
"""


def _backend_devices():
    """The CUDA cards (cuda:0, ...) and the CPU; the first is the default."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [f"cuda:{i}" for i in range(n)] + ["cpu"]


def _backend_dtypes():
    return ["float32", "float64"]


def _pick_device(name):
    """The torch device of a form's device name ("cuda:1", "cpu", "cpu:0"),
    or None (the card) for a blank or unknown one."""
    import torch

    if not name:
        return None
    platform, _, idx = name.partition(":")
    if platform == "cpu":
        return torch.device("cpu")
    if platform == "cuda" and torch.cuda.is_available():
        i = int(idx or 0)
        if i < torch.cuda.device_count():
            return torch.device("cuda", i)
    return None


def _n_end_cap(d, n_balls):
    from ..biem import max_n_end

    try:
        import psutil

        mem = psutil.virtual_memory().available // 16
    except ImportError:
        mem = 4 * 2**30
    return max(max_n_end(c_ndim=d, memory_limit=mem, n_balls=n_balls), 1)


def _solve_and_plot(form):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    from ..biem import biem, plane_wave
    from ..coords import (
        create_from_branching_types,
        create_hopf,
        create_random,
        create_standard,
        create_standard_prime,
    )
    from ..ops.kernels import default_device
    from ..plot import animate_biem, plot_biem, plot_biem_far

    ctype = form.get("ctype", "standard")
    dim = int(form.get("dim", "3"))
    if ctype == "standard":
        c = create_standard(dim)
    elif ctype == "standard_prime":
        c = create_standard_prime(dim)
    elif ctype == "hopf":
        c = create_hopf(dim)
    elif ctype == "random":
        c = create_random(dim)
    else:
        c = create_from_branching_types(form.get("btype", "ba"))
    d = c.c_ndim
    rdt = torch.float64 if "float64" in form.get("dtype", "float32") else torch.float32
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64

    raw_rows = form.get("sphere_list") or (
        form["spheres"].splitlines() if form.get("spheres") else _DEFAULT_SPHERES
    )
    rows = [ln.strip() for ln in raw_rows if ln.strip()]
    alphas, betas, radii, centers = [], [], [], []
    for ln in rows:
        a, b, r, ctr = [p.strip() for p in ln.split(",")]
        alphas.append(complex(a))
        betas.append(complex(b))
        radii.append(float(r))
        vec = [float(v) for v in ctr.split()]
        if len(vec) != d:
            raise ValueError(f"center {vec} has {len(vec)} coords, need {d}")
        centers.append(vec)
    k = complex(form.get("k", "1"))
    eta = float(form.get("eta", "1"))
    n_end = int(form.get("n_end", "6"))
    # cap by available memory (reference gui.py:189-199)
    cap = _n_end_cap(d, len(rows))
    n_end = min(n_end, cap)

    dev = _pick_device(form.get("device", "")) or default_device()
    real = dict(dtype=rdt, device=dev)
    direction = torch.zeros(d, **real)
    direction[0] = 1.0
    k_in = (torch.tensor(k.real, **real) if k.imag == 0
            else torch.tensor(k, dtype=cdt, device=dev))
    uin, uin_grad = plane_wave(k=k_in, direction=direction)
    calc = biem(
        c,
        centers=torch.tensor(centers, **real),
        radii=torch.tensor(radii, **real),
        k=k_in,
        n_end=n_end,
        alpha=torch.tensor(alphas, dtype=cdt, device=dev),
        beta=torch.tensor(betas, dtype=cdt, device=dev),
        uin=uin,
        uin_grad=uin_grad if any(abs(b) > 0 for b in betas) else None,
        eta=torch.tensor(eta, **real),
        kind=form.get("kind", "outer"),
        force_matrix="force_matrix" in form,
    )
    axes = tuple(int(v) for v in form.get("axes", "0 1").replace(",", " ").split())
    balls_s = form.get("balls", "").strip()
    balls = [int(v) for v in balls_s.replace(",", " ").split()] if balls_s else None
    fmt = form.get("fmt", "png")
    imgs = []
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
    ax2.remove()
    ax2 = fig.add_subplot(1, 2, 2, projection="polar")
    plot_biem(
        calc,
        t=float(form.get("t", "0")),
        axes=axes,
        lim=float(form.get("lim", "6")),
        balls=balls,
        use_signed_log="slog" in form,
        ax=ax1,
    )
    plot_biem_far(calc, axes=axes, ax=ax2)
    buf = io.BytesIO()
    fig.savefig(buf, format=fmt, dpi=110, bbox_inches="tight")
    plt.close(fig)
    mime = {"png": "image/png", "jpg": "image/jpeg", "svg": "image/svg+xml"}[fmt]
    imgs.append(
        f'<img src="data:{mime};base64,{base64.b64encode(buf.getvalue()).decode()}">'
    )
    if "animate" in form:
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".gif") as tmp:
            animate_biem(
                calc,
                tmp.name,
                axes=axes,
                lim=float(form.get("lim", "6")),
                balls=balls,
                use_signed_log="slog" in form,
            )
            with open(tmp.name, "rb") as fh:
                gif = fh.read()
        imgs.append(
            f'<img src="data:image/gif;base64,{base64.b64encode(gif).decode()}">'
        )
    u0 = complex(calc.uscat(torch.zeros((d, 1), **real)).reshape(-1)[0])
    dens_dev = calc.density.device
    status = (
        f"<p>uscat(0) = {u0:.6f} &nbsp; (n_end used: {n_end}, "
        f"device: {'cpu' if dens_dev.type == 'cpu' else f'cuda:{dens_dev.index}'}, "
        f"dtype: {str(calc.density.dtype).removeprefix('torch.')})</p>"
    )
    return status, "".join(imgs)


class _Handler(BaseHTTPRequestHandler):
    def _respond(self, form):
        status, images = "", ""
        if form.get("_submitted"):
            try:
                status, images = _locked_solve_and_plot(form)
            except Exception:
                # notification-style error panel (reference gui.py:410-412)
                status = f'<div class="err">{html.escape(traceback.format_exc())}</div>'
        devices = _backend_devices()
        dtypes = _backend_dtypes()
        sel_dev = form.get("device", "")
        dev_opts = "".join(
            f'<option {"selected" if s == sel_dev else ""}>{html.escape(s)}</option>'
            for s in devices
        )
        sel_dt = form.get("dtype", "float32")
        dt_opts = "".join(
            f'<option {"selected" if s == sel_dt else ""}>{html.escape(s)}</option>'
            for s in dtypes
        )
        rows = form.get("sphere_list", _DEFAULT_SPHERES)
        sphere_rows = "".join(
            '<div><input class="sphere" name="sphere" value="'
            + html.escape(ln, quote=True)
            + '"> <button type="button" onclick="this.parentNode.remove()">&minus;</button></div>'
            for ln in rows
        )
        try:
            cap = _n_end_cap(int(form.get("dim", "3")), max(len(rows), 1))
        except Exception:
            cap = "?"
        page = _PAGE.format(
            standard="selected" if form.get("ctype", "standard") == "standard" else "",
            standard_prime="selected" if form.get("ctype") == "standard_prime" else "",
            hopf="selected" if form.get("ctype") == "hopf" else "",
            random="selected" if form.get("ctype") == "random" else "",
            custom="selected" if form.get("ctype") == "custom" else "",
            dim=html.escape(form.get("dim", "3")),
            btype=html.escape(form.get("btype", "ba")),
            device_options=dev_opts,
            dtype_options=dt_opts,
            k=html.escape(form.get("k", "1")),
            eta=html.escape(form.get("eta", "1")),
            n_end=html.escape(form.get("n_end", "6")),
            n_end_cap=cap,
            outer="selected" if form.get("kind", "outer") == "outer" else "",
            inner="selected" if form.get("kind") == "inner" else "",
            force_matrix="checked" if "force_matrix" in form else "",
            sphere_rows=sphere_rows,
            axes=html.escape(form.get("axes", "0 1")),
            lim=html.escape(form.get("lim", "6")),
            t=html.escape(form.get("t", "0")),
            animate="checked" if "animate" in form else "",
            balls=html.escape(form.get("balls", "")),
            slog="checked" if "slog" in form else "",
            # reactive defaults ON for a fresh page; a submitted form
            # without the field means the user unchecked it
            reactive="checked"
            if ("reactive" in form or not form.get("_submitted"))
            else "",
            status=status,
            images=images,
        )
        body = page.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self._respond({})

    def _respond_fragment(self, form):
        """Reactive-push endpoint: compute and return ONLY the result
        panes (status + images) for in-place swapping — the stdlib
        equivalent of the reference's per-widget-change websocket push
        (reference gui.py:256-338).  Requests superseded by a newer
        ``__seq`` while queued behind the compute lock are answered 204
        without any device work."""
        try:
            seq = int(form.get("__seq", "0") or 0)
        except ValueError:
            seq = 0
        try:
            result = _locked_solve_and_plot(
                form, seq=seq, client=form.get("__cid", "")
            )
        except Exception:
            status = f'<div class="err">{html.escape(traceback.format_exc())}</div>'
            images = ""
        else:
            if result is None:  # superseded — dropped server-side
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            status, images = result
        body = f"<div>{status}</div>\n<div>{images}</div>".encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        length = int(self.headers.get("Content-Length", "0"))
        raw = self.rfile.read(length).decode()
        parsed = parse_qs(raw, keep_blank_values=True)
        form = {k: v[0] for k, v in parsed.items()}
        form["sphere_list"] = parsed.get("sphere", [])
        # legacy single-textarea clients (round-1 form layout)
        if not form["sphere_list"] and form.get("spheres"):
            form["sphere_list"] = form["spheres"].splitlines()
        form["_submitted"] = "1"
        if self.path == "/compute":
            self._respond_fragment(form)
        else:
            self._respond(form)

    def log_message(self, fmt, *args):
        log.debug("gui: " + fmt, *args)


def servable():
    """Return the handler class (parity with reference gui.servable())."""
    return _Handler


def serve(port=7860):
    """Serve the GUI (reference: cli serve -> port 7860, cli.py:30-33)."""
    httpd = ThreadingHTTPServer(("0.0.0.0", port), _Handler)
    print(f"serving GUI on http://0.0.0.0:{port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
