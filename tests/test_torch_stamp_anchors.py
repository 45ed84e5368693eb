"""The clock64 stamp script's anchors against the solve kernel's source.

``scripts/stamp_solve_kernel.py::stamped_source`` inserts a stamp at each
phase boundary of ``cg_core`` (one warp per env) and ``cg_core_wide`` by
regex anchors on their lines and raises where one is missing. An edit of
either core can move an anchor; these tests find every anchor on the
tree's ``cg_fused.cu`` without a card or a compiler (pure string work, ~2 s
with the imports), and check that the ``euler`` phase brackets the whole
velocity update, the damped tail (``euler_damped``: the factor of M + h
diag(B) and both substitutions) included.
"""

from __future__ import annotations

import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import stamp_solve_kernel as stamp  # noqa: E402

CG_FUSED = os.path.join(ROOT, "brax_tracking_tpu_torch", "ops", "csrc", "cg_fused.cu")


def _source() -> str:
    with open(CG_FUSED) as f:
        return f.read()


def _core(src: str, name: str) -> str:
    lo, hi = stamp._span(src, f"__device__ __forceinline__ void {name}(const Args& a, ")
    return src[lo:hi]


@pytest.mark.parametrize("wide", [False, True], ids=["one_warp", "wide"])
def test_every_anchor_found(wide):
    src = _source()
    text, phases = stamp.stamped_source(src, wide=wide)
    # the products share phi'(0)'s pass in both cores
    assert phases == ("assembly", "sweep", "start", "products_phi0", "bracket", "ls", "step",
                      "outputs", "euler")
    core = _core(text, "cg_core_wide" if wide else "cg_core")
    marks = [int(k) for k in re.findall(r"st\.mark\((\d+)\);", core)]
    # every phase but the assembly (marked before the core is called) once,
    # in the order of PHASES
    want = [stamp.PHASES.index(p if p != "products_phi0" else "phi0") for p in phases[1:]]
    assert marks == want
    assert core.count("st.c[%d] += 1;" % (stamp.NSLOT - 1)) == 1
    assert core.count("st.write(b, ") == 1
    # the assembly's stamp before each kernel's call of the core, and the
    # Stamps set up after each kernel's carve
    call = "cg_core_wide<kEll, kWarm, kL2, kW>(" if wide else "cg_core<kEll, kWarm>("
    assert text.count("st.mark(0);\n") == 2
    assert len(re.findall(re.escape(call) + r"a, s, b, \w+, st\);", text)) == 2
    assert text.count("Stamps st;\n  st.init();") == 2
    assert 'extern "C" int stamp_set(long long* p)' in text


@pytest.mark.parametrize("wide", [False, True], ids=["one_warp", "wide"])
def test_euler_brackets_the_damped_tail(wide):
    text, _ = stamp.stamped_source(_source(), wide=wide)
    core = _core(text, "cg_core_wide" if wide else "cg_core")
    outputs = core.index("st.mark(%d);" % stamp.PHASES.index("outputs"))
    euler = core.index("st.mark(%d);" % stamp.PHASES.index("euler"))
    tail = core.index("euler_damped<")
    undamped = core.index("qvel_new[v] = __ldg(qvel + v) + a.dt * s.x[v];")
    assert outputs < tail < euler and outputs < undamped < euler
    # nothing of the core after the euler stamp but its write and the end
    assert re.fullmatch(r"\s*st\.write\(b, \w+\);\s*\}\s*", core[core.index(";", euler) + 1:])


def test_missing_anchor_raises():
    src = _source()
    lo, hi = stamp._span(src, "__device__ __forceinline__ void cg_core(const Args& a, ")
    body = src[lo:hi].replace("  bool done = false;\n", "  bool done_ = false;\n", 1)
    with pytest.raises(ValueError, match="anchor"):
        stamp.stamped_source(src[:lo] + body + src[hi:])
