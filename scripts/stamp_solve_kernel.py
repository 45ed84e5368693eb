"""Split one solve-kernel launch into phases by clock64 stamps, per env.

    python3 scripts/stamp_solve_kernel.py [--root DIR] [--pair | --rodent | --terrain | --fly]

Copies ``DIR``'s ``brax_tracking_tpu_torch/ops/csrc/cg_fused.cu`` (default:
this checkout's) to ``runs/stamp/`` with a ``clock64()`` stamp at each phase
boundary of ``cg_core`` and its two kernels, builds the copy with ``nvcc``
into a library of its own and runs it on chip_smoke.py's seeded states
(2048 envs) of the three ``cg_solve_fused`` instances: (a) the minirat,
(b) the elliptic minirat, (c) a Newton chunk; with ``--pair``, the same
three on the two-rat stand-in (1024 envs, layout 2: J in device memory),
which run the wide core (``cg_core_wide``, several warps per env); with
``--rodent``, (a) on the one rat (undamped) and on the rodent stand-in
(its own joint damping: the damped Euler tail), 2048 envs, the wide core
in layout 1; with ``--terrain``, (a) on the rodent stand-in's terrain
(367 rows, damped), 2048 envs, the wide layout 1; with ``--fly``, (b) on
the fly stand-in, free and tethered
(``fly_standin``, ``fly_standin_tethered``: the one-warp elliptic
instance), 2048 envs. Lane 0
of each env (thread 0 in the wide core, whose warp runs the core's scalar
work) adds the cycles since the last stamp to its phase:

- ``assembly``: qM and J (or their dense loads) and the per-env vectors;
- ``sweep``: M^-1;
- ``start``: qacc_smooth, the first J x, the cost and the gradients;
- per CG iteration: ``products`` (J p, M p and their dots), ``phi0``
  (phi'(0) and the first guess), ``bracket`` (phi' at the 13 candidates),
  ``ls`` (the line search), ``step`` (the new iterate's cost, forces and
  gradients);
- ``outputs``: J^T force and the writes; ``euler``: the velocity update
  (with damping the whole tail, euler_damped: the factor of M + h diag(B)
  and both substitutions).

A core that forms J p, M p and phi'(0) in one row pass has one phase,
``products_phi0``, for the two. Which layout the source has is read from
its anchors; every anchor of that layout must be found, so an edit of the
core that moves one fails here rather than folding a phase into another.

Prints one JSON line per instance: the mean cycles per env of each phase,
their shares, the mean CG iterations, and the unstamped kernel's device us
per launch (torch.profiler, the tree's own library) beside the stamped
copy's.
The copy never enters the tree's sources; ``runs/`` is not committed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from ab_solve_kernel import device_us

PHASES = ("assembly", "sweep", "start", "products", "phi0", "bracket", "ls", "step",
          "outputs", "euler")
NSLOT = len(PHASES) + 1  # the last slot counts CG iterations
# the line that ends the products where they have a pass of their own, and
# the one that reads their sums where they share phi'(0)'s pass
SPLIT_PRODUCTS = r"^ +const float gauss_p = dot\(s\.p, s\.mxa, nv, lane\);$"
FUSED_PRODUCTS = r"^ +const float pmp = r4\[0\], gauss_p = r4\[1\];$"

STAMPS = """
constexpr int kNStamp = %d;
__device__ long long* g_stamp;
struct Stamps {
  long long c[kNStamp];
  long long last;
  __device__ __forceinline__ void init() {
    for (int k = 0; k < kNStamp; ++k) c[k] = 0;
    last = clock64();
  }
  __device__ __forceinline__ void mark(int k) {
    __syncwarp();
    const long long now = clock64();
    c[k] += now - last;
    last = now;
  }
  __device__ __forceinline__ void write(int b, int lane) {
    if (lane == 0 && g_stamp)
      for (int k = 0; k < kNStamp; ++k) g_stamp[(size_t)b * kNStamp + k] = c[k];
  }
};
"""


def _span(src: str, head: str) -> tuple[int, int]:
    """The [start, end) of the function whose definition starts with
    ``head`` (up to its closing brace at column 0)."""
    start = src.index(head)
    return start, src.index("\n}\n", start) + 3


def stamped_source(src: str, wide: bool = False) -> tuple[str, tuple[str, ...]]:
    """``src`` with the stamps inserted after (or before) anchor lines of
    the solve core (the one-warp ``cg_core``, or with ``wide`` the wide
    ``cg_core_wide``, whose scalar work runs on warp 0: thread 0's clock
    splits it, waits at the block's barriers included), and the phases it
    reports; raises if an anchor of the core is missing or found more often
    than expected."""
    core = "cg_core_wide" if wide else "cg_core"
    head = f"__device__ __forceinline__ void {core}(const Args& a, "
    lo, hi = _span(src, head)
    body = src[lo:hi]
    split = len(re.findall(SPLIT_PRODUCTS, body, flags=re.M))
    fused = len(re.findall(FUSED_PRODUCTS, body, flags=re.M))
    if (split, fused) not in ((1, 0), (0, 1)):
        raise ValueError(f"products anchors found {split} (own pass) and {fused} (shared "
                         "with phi'(0)) times; expected one of them once")

    def edit(text, pattern, new, count):
        out, n = re.subn(pattern, new, text, flags=re.M)
        if n != count:
            raise ValueError(f"anchor {pattern!r} found {n} times")
        return out

    def after(pattern, text, count=1):
        nonlocal body
        body = edit(body, pattern, lambda m: m.group(0) + text, count)

    def before(pattern, text, count=1):
        nonlocal body
        body = edit(body, pattern, lambda m: text + m.group(0), count)

    ph = {p: k for k, p in enumerate(PHASES)}
    mark = lambda p: f"\n  st.mark({ph[p]});"
    who = "tid" if wide else "lane"
    after(rf"void {core}\(const Args& a, const Smem\w? ?& s, int b, int {who}", ", Stamps& st")
    if wide:
        after(r"^  sweep::panels<kWide, kPanel>\(.*\);$", mark("sweep"))
    else:
        before(r"^  matvec\(s\.Mi, ld, s\.qfs, s\.a0, nv, nv, lane\);$",
               f"  st.mark({ph['sweep']});\n")
    before(r"^  bool done = false;$", f"  st.mark({ph['start']});\n")
    after(r"^    if \(done\) break;.*$", f"\n    st.c[{NSLOT - 1}] += 1;")
    if split:
        after(SPLIT_PRODUCTS, mark("products"))
    after(r"^ +const float guess = .*;$", mark("phi0"))
    before(r"^ +float alpha = fminf\(guess, hi\);$", f"    st.mark({ph['bracket']});\n")
    before(r"^ +// step, then the (constraint )?cost", f"    st.mark({ph['ls']});\n")
    after(r"improvement < stall_tol \* fabsf\(cost_new\)\);$", mark("step"))
    after(rf"^  if \({who} == 0\) a\.done\[b\] = done \? 1 : 0;$", mark("outputs"))
    after(rf"qvel_new\[v\] = __ldg\(qvel \+ v\) \+ a\.dt \* s\.x\[v\];\n  \}}",
          mark("euler") + f"\n  st.write(b, {who});")
    src = src[:lo] + body + src[hi:]

    def whole(pattern, new, count):
        nonlocal src
        src = edit(src, pattern, new, count)

    whole(r"^constexpr float kMinval = .*;$", lambda m: m.group(0) + STAMPS % NSLOT, 1)
    # the wide carve with or without J's stored values (jnnz, since the wide
    # core holds J by its pattern)
    carve = (r"^  +SmemW s = carve_wide<kL2>\(smw, nv, nefc, a\.nell(?:, jnnz)?\);$" if wide
             else r"^  +Smem s = carve\(sm, nv, nefc, a\.nell\);$")
    whole(carve, lambda m: m.group(0) + "\n  Stamps st;\n  st.init();", 2)
    # the wide core's third parameter: where J lives (kL2) or how (kDenseJ)
    call = (r"^( +)cg_core_wide<kEll, kWarm, k(?:L2|DenseJ), kW>\(a, s, b, tid\);$" if wide
            else r"^( +)cg_core<kEll, kWarm>\(a, s, b, lane\);$")
    whole(call, lambda m: f"{m.group(1)}st.mark(0);\n" + m.group(0)[:-2] + ", st);", 2)
    whole(r"^\}  // namespace$", lambda m: m.group(0) + """

extern "C" int stamp_set(long long* p) {
  return (int)cudaMemcpyToSymbol(g_stamp, &p, sizeof(p));
}""", 1)
    if split:
        return src, PHASES
    return src, tuple("products_phi0" if p == "phi0" else p for p in PHASES if p != "products")


def main() -> int:
    ap = argparse.ArgumentParser()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--root", default=here)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--pair", action="store_true",
                       help="the stand-in's instances (layout 2) instead of the minirat's")
    which.add_argument("--rodent", action="store_true",
                       help="(a) on the one rat and the damped rodent stand-in (wide layout 1)")
    which.add_argument("--terrain", action="store_true",
                       help="(a) on the damped rodent stand-in's terrain (wide layout 1)")
    which.add_argument("--fly", action="store_true",
                       help="(b) on the free and the tethered fly stand-in (one warp, elliptic)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    from torch.utils.cpp_extension import CUDA_HOME

    from brax_tracking_tpu_torch.ops import library

    torch.backends.cuda.matmul.allow_tf32 = False
    csrc = os.path.join(root, "brax_tracking_tpu_torch", "ops", "csrc")
    out_dir = os.path.join(here, "runs", "stamp")
    os.makedirs(out_dir, exist_ok=True)
    tag = re.sub(r"\W", "_", os.path.relpath(root, here)).strip("_") or "tree"
    cu = os.path.join(out_dir, f"cg_stamped_{tag}.cu")
    with open(os.path.join(csrc, "cg_fused.cu")) as f:
        text, phases = stamped_source(f.read(), wide=args.pair or args.rodent or args.terrain)
    slots = [PHASES.index("phi0" if p == "products_phi0" else p) for p in phases]
    with open(cu, "w") as f:
        f.write(text)
    so = os.path.join(out_dir, f"libstamped_{tag}.so")
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-O3",
                    "-gencode=arch=compute_90a,code=sm_90a", "-I", csrc, "-shared",
                    "-Xcompiler", "-fPIC", "-o", so, cu], check=True, timeout=600)
    stamped = ctypes.CDLL(so)
    for name in ("cg_fused_launch", "cg_batched_launch"):
        getattr(stamped, name).argtypes = library._SIGNATURES[name]
        getattr(stamped, name).restype = ctypes.c_int
    stamped.stamp_set.argtypes = [ctypes.c_void_p]
    stamped.stamp_set.restype = ctypes.c_int
    library.build()
    own = library._LIB
    card = cs.card_line()
    if args.rodent:
        B, reps, instances = cs.B_MAIN, 20, (("a", "rat"), ("a", "rodent_standin"))
    elif args.terrain:
        B, reps, instances = cs.B_MAIN, 20, (("a", "rodent_standin_terrain"),)
    elif args.fly:
        B, reps, instances = cs.B_MAIN, 20, tuple(("b", m) for m in cs.FLY_MODELS)
    else:
        family, B, reps = ("ratpair", cs.B_PAIR, 10) if args.pair else ("minirat", cs.B_MAIN, 100)
        instances = (("a", family), ("b", f"{family}_elliptic"), ("c", f"{family}_newton"))
    for key, model in instances:
        library._LIB = own
        _, kargs, kw = cs.solve_case("cuda", model, B, cs.SEED)
        launch = cs.kernel_launch(kargs, kw)
        t_own = min(device_us(launch, "cg_fused_kernel", reps) for _ in range(3))
        library._LIB = stamped
        t_stamped = min(device_us(launch, "cg_fused_kernel", reps) for _ in range(3))
        buf = torch.zeros(B, NSLOT, dtype=torch.int64, device="cuda")
        if stamped.stamp_set(ctypes.c_void_p(buf.data_ptr())) != 0:
            cs.fail("stamp_set failed")
        launch()
        torch.cuda.synchronize()
        stamped.stamp_set(ctypes.c_void_p(None))
        c = buf.double()
        mean = c[:, slots].mean(0)
        print(json.dumps({
            "root": root, "instance": key, "model": model, "card": card,
            "iters": kw["iters"], "ls_iters": kw["ls_iters"], "damped": kw["has_damping"],
            "mean_cg_iterations": float(c[:, -1].mean()),
            "kernel_us": t_own, "stamped_kernel_us": t_stamped,
            "cycles_per_env": float(mean.sum()),
            "cycles": {p: float(v) for p, v in zip(phases, mean)},
            "share": {p: float(v / mean.sum()) for p, v in zip(phases, mean)},
        }), flush=True)
    library._LIB = own
    return 0


if __name__ == "__main__":
    sys.exit(main())
