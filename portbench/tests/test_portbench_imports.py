"""What a run loads: no JAX and no JAX package, compared by whole
top-level module names (the program's name begins with the JAX
package's); and the reference alone loads nothing of the program."""

from portbench.tests import _tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "ravqa_tpu"}

LOADED = """
import sys, time
from portbench.run import run_cell
from portbench.tests import _tiny
r = run_cell({cell!r}, 5, 0.5, False, "cpu", time.perf_counter(),
             overrides=_tiny.overrides({cell!r}))
assert r["correct"], r
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax():
    for cell in ("flmr_exact_burst", "flmr_train"):
        names = set(_tiny.python(LOADED.format(cell=cell), _tiny.ROOT,
                                 [_tiny.ROOT]).split())
        assert "ravqa_tpu_torch" in names
        assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.towers, "
            "portbench.reference.search, portbench.reference.train, "
            "portbench.reference.tokenize; print(' '.join(sorted({m.split("
            "'.')[0] for m in sys.modules})))")
    names = set(_tiny.python(code, _tiny.ROOT, [_tiny.ROOT]).split())
    assert not names & (FORBIDDEN | {"ravqa_tpu_torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    from portbench.run import forbidden_modules
    monkeypatch.setitem(sys.modules, "ravqa_tpu_torch_extra", sys)
    assert "ravqa_tpu_torch_extra" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert forbidden_modules() == ["jax"]
