"""Where the time goes inside kernels E and F, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_phases.py

It builds copies of ``ptzjax_torch/csrc/lk_flow.cu`` and ``describe.cu`` in
which thread 0 of each of the first 64 CTAs stores ``clock64()`` at the
phase boundaries named below (text inserted at fixed anchors of the
sources: a changed source fails here loudly), each into a library of its
own under a temporary directory, and runs them on ``chip_smoke.py``'s
inputs: kernel F on 512 keypoints of the LK bench frame, scaled (1.0) and
not; kernel E's LK launch at the LK bench shape; its pyramid launch on the
720p pair. It prints the mean SM cycles of each phase, the device time of
the unmodified kernel (the profiler's, as ``chip_smoke.py`` reads it), and
the LK launch's device time at several level and Newton-step settings. A
phase's cycles include the time its warps wait for issue slots that the
SM's other CTAs hold.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

STAMPS = """
__device__ long long g_stamps[64][64];
__shared__ int stamp_i;
#define STAMP_AT(b) do { if (threadIdx.x == 0 && (b) < 64) g_stamps[b][stamp_i++] = clock64(); } while (0)
#define STAMP() STAMP_AT(blockIdx.x)
#define PSTAMP() STAMP_AT(blockIdx.z == 0 ? blockIdx.x + gridDim.x * blockIdx.y : 64)
extern "C" int ptz_stamps(void* dst) { return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps)); }
"""

F_PHASES = ("loads", "taps", "window", "resample", "pixels", "histogram", "norm")
F_ANCHORS = (
    ("  float* dst = out + (size_t)k * kDim;\n", "  if (threadIdx.x == 0) stamp_i = 0;\n  STAMP();\n"),
    ("  const int win = scaled ? kScaledWin : kSub;\n", None),
    ("  // the window: every copy", "before"),
    ("cp.async.wait_all;\\n\" ::: \"memory\");\n  __syncthreads();\n", None),
    ("  // pixels t and t + 128", "before"),
    ("  bad = __syncthreads_or(bad);\n", None),
    ("  if (bad) v = __int_as_float(0x7fffffff);   // NaN\n", "before"),
    ("  dst[t] = v;\n", None),
)
E_PHASES = ("search + template", "blend", "G", "search wait", "Newton", "residual")
E_ANCHORS = (
    ("  const int kp = blockIdx.x;\n", "  if (threadIdx.x == 0) stamp_i = 0;\n  STAMP();\n"),
    ("                             float gy, int iters, Prefetch prefetch) {\n", None),
    ("// the template; the search window in flight\n  __syncthreads();\n", None),
    ("      sm.blend[s] = v;\n    }\n  }\n  __syncthreads();\n", None),
    ("  cta_sum(g, sm, slot);\n", None),
    ("// the search window; the prefetch in flight\n  __syncthreads();\n", None),
    ("  // the residual, mean |template - sample|", "before"),
    ("  cta_sum(r, sm, slot);\n", None),
)
P_PHASES = ("vertical 1", "pool 1", "vertical 2", "pool 2", "vertical 3", "pool 3")
P_ANCHORS = (
    ("  const float* lev = nullptr;    // level k's region in shared memory (k >= 1)\n",
     "  if (threadIdx.x == 0) stamp_i = 0;\n  PSTAMP();\n"),
    ("    __syncthreads();\n    // the horizontal blur", "PSTAMP"),
    ("    __syncthreads();\n    lev = next;", "PSTAMP"),
)


def instrumented(src: Path, anchors, out_dir: str, name: str) -> ctypes.CDLL:
    """``src`` with a stamp after (or before) each anchor, built alone as
    ``name``.so."""
    from ptzjax_torch.kernels import _build

    text = STAMPS + open(src).read()
    for anchor, how in anchors:
        if anchor not in text:
            raise RuntimeError(f"chip_phases: {src.name} no longer holds {anchor!r}")
        if how == "before":
            text = text.replace(anchor, "  STAMP();\n" + anchor, 1)
        elif how == "PSTAMP":
            head, tail = anchor.split("\n", 1)
            text = text.replace(anchor, head + "\n    PSTAMP();\n" + tail, 1)
        else:
            text = text.replace(anchor, anchor + (how or "  STAMP();\n"), 1)
    path = Path(out_dir) / f"{name}.cu"
    path.write_text(text)
    lib = path.with_suffix(".so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"chip_phases: nvcc failed on {path}:\n{proc.stderr}")
    out = ctypes.CDLL(str(lib))
    out.ptz_stamps.argtypes = [ctypes.c_void_p]
    return out


def phases(lib, names, call, per_cta: int | None = None) -> str:
    """Run ``call`` three times, read the stamps: mean cycles a phase over
    those of CTAs 0-63 that stamped them all (the first ``len(names) + 1``
    stamps, or ``per_cta`` stamps grouped into repeats of ``names``)."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    buf = np.zeros((64, 64), np.int64)
    if lib.ptz_stamps(buf.ctypes.data):
        raise RuntimeError("chip_phases: reading the stamps failed")
    n = per_cta or len(names) + 1
    whole = buf[:, n - 1] != 0   # CTAs that reached the last stamp (a rejected row skips the backward check)
    d = np.diff(buf[whole, :n], axis=1).mean(0)
    if per_cta is None:
        return ", ".join(f"{k} {v:.0f}" for k, v in zip(names, d)) + f"; total {d.sum():.0f}"
    groups = []
    for g in range(0, len(d) - len(names) + 1, len(names) + 1):
        groups.append(", ".join(f"{k} {v:.0f}" for k, v in zip(names, d[g + 1 : g + 1 + len(names)])))
    return f"before the first level {d[0]:.0f}; " + " | ".join(groups) + f"; total {d.sum():.0f}"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    from ptzjax_torch.config import SLAMConfig
    from ptzjax_torch.kernels import _build
    from ptzjax_torch.kernels import descriptor as kd
    from ptzjax_torch.kernels import flow as fl
    from ptzjax_torch.kernels.detect import detect_keypoints

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    _build.load()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    on = [torch.from_numpy(a).to(dev) for a in cs.lk_bench_inputs()]
    kp = detect_keypoints(on[0], 512, threshold=SLAMConfig().detector_threshold)
    xy, valid = kp.xy.contiguous(), kp.valid.contiguous()
    one = torch.tensor([1.0], device=dev)
    desc = torch.empty((512, kd.DESC_DIM), device=dev)
    pyrs = fl.build_pyramids([on[0], on[1]], 4)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    with tempfile.TemporaryDirectory() as tmp:
        f_lib = instrumented(_build._CSRC / "describe.cu", F_ANCHORS, tmp, "f_phases")
        f_lib.ptz_describe.argtypes = [vp, ci, ci] + [vp] * 4 + [ci, ci, vp]
        for s in (one, None):
            def f_call():
                f_lib.ptz_describe(on[0].data_ptr(), *on[0].shape, xy.data_ptr(), valid.data_ptr(),
                                   None if s is None else s.data_ptr(), desc.data_ptr(), 512, 0, stream)
            ms = cs.device_time(lambda: kd.describe_kernel(on[0], xy, valid, s), per_call=1)[0]
            print(f"kernel F, 512 kp, {'scale 1.0' if s is not None else 'no scale'}: {ms:.4f} ms device; "
                  f"cycles a phase: {phases(f_lib, F_PHASES, f_call)} [{card}]")

        e_lib = instrumented(_build._CSRC / "lk_flow.cu", E_ANCHORS, tmp, "e_phases")
        vpp, cip = ctypes.POINTER(vp), ctypes.POINTER(ci)
        e_lib.ptz_lk_flow.argtypes = [vpp, vpp, cip, cip, ci] + [vp] * 5 + [ci] * 4 + [cf] * 6 + [ci, ci, vp]
        out_xy, out_res = torch.empty_like(on[2]), torch.empty(512, device=dev)
        out_tr = torch.empty(512, dtype=torch.bool, device=dev)
        levels = (vp * 4)(*(a.data_ptr() for a in pyrs[0])), (vp * 4)(*(a.data_ptr() for a in pyrs[1]))
        h, w = on[0].shape
        hs, ws = (ci * 4)(*(h >> i for i in range(4))), (ci * 4)(*(w >> i for i in range(4)))
        o = cs.LK_OPTS

        def e_call():
            e_lib.ptz_lk_flow(*levels, hs, ws, 4, on[2].data_ptr(), on[3].data_ptr(), out_xy.data_ptr(),
                              out_tr.data_ptr(), out_res.data_ptr(), 512, o["patch"], o["iters"],
                              max(3, o["iters"] // 2), o["min_eig"], o["max_residual"], o["border"],
                              w - 1 - o["border"], h - 1 - o["border"], o["fb_tol"], 1, 0, stream)

        ms = cs.device_time(lambda: fl.lk_pyramids(pyrs[0], pyrs[1], on[2], on[3], **o), per_call=1)[0]
        print(f"kernel E's LK launch, 512 kp, 4 levels + backward check: {ms:.4f} ms device; cycles a phase, "
              f"coarse to fine, then the backward check: {phases(e_lib, E_PHASES, e_call, per_cta=36)} [{card}]")
        for lv, iters, fb in ((1, 0, False), (1, 8, False), (4, 0, False), (4, 8, False), (4, 8, True)):
            opts = dict(o, iters=iters, fb_check=fb)
            ms = cs.device_time(lambda: fl.lk_pyramids(pyrs[0][:lv], pyrs[1][:lv], on[2], on[3], **opts), per_call=1)[0]
            print(f"kernel E's LK launch at {lv} level(s), {iters} Newton steps at level 0 "
                  f"({max(3, iters // 2)} above), backward check {fb}: {ms:.4f} ms device [{card}]")

        p_lib = instrumented(_build._CSRC / "lk_flow.cu", P_ANCHORS, tmp, "pyramid_phases")
        p_lib.ptz_pyramid.argtypes = [vpp, vpp, cip, cip, ci, ci, ci, vp]
        bases = (vp * 2)(on[0].data_ptr(), on[1].data_ptr())
        outs = (vp * 6)(*(pyrs[f][k].data_ptr() for f in range(2) for k in range(1, 4)))

        def p_call():
            p_lib.ptz_pyramid(bases, outs, hs, ws, 2, 3, 0, stream)

        ms = cs.device_time(lambda: fl.build_pyramids([on[0], on[1]], 4), per_call=1)[0]
        print(f"kernel E's pyramid launch, 720p pair, levels 1-3: {ms:.4f} ms device; cycles a phase (CTAs 0-63 "
              f"of the first frame): {phases(p_lib, P_PHASES, p_call)} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
