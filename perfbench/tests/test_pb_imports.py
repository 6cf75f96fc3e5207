"""What the benchmark loads: neither JAX nor the JAX package (nor its old
benchmark), by top-level module name compared whole; and the reference
loads nothing of the program."""

import subprocess
import sys

from perfbench import harness

_CHECK = """
import sys
{imports}
bad = sorted({{m.split('.')[0] for m in sys.modules}} & set({names!r}))
print(','.join(bad))
"""


def _loaded(imports: str, names) -> str:
    out = subprocess.run(
        [sys.executable, "-c", _CHECK.format(imports=imports, names=names)],
        cwd=harness.REPO, capture_output=True, text=True, timeout=300,
        check=True)
    return out.stdout.strip()


def test_harness_loads_no_jax():
    imports = ("import perfbench.run, perfbench.harness, perfbench.check, "
               "perfbench.readings, perfbench.tracing\n"
               "import snail_tpu_torch.render.renderer, "
               "snail_tpu_torch.scene.bench_scenes, "
               "snail_tpu_torch.bvh.cache, snail_tpu_torch.scene.scene")
    assert _loaded(imports, list(harness.FORBIDDEN)) == ""


def test_reference_loads_nothing_of_the_program():
    imports = "import perfbench.reference.render, perfbench.reference.hits"
    assert _loaded(imports, ["snail_tpu_torch", "snail_tpu", "jax"]) == ""


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("snail_tpu_torch_lookalike", sys)
    try:
        assert "snail_tpu_torch_lookalike" not in harness.forbidden_modules()
    finally:
        del sys.modules["snail_tpu_torch_lookalike"]
