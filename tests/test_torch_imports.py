"""Every module of ``repro_torch`` imports on its own, first thing in a
fresh process: one case per module.

An import cycle shows only for the module that starts it (the kernel
packages import ``core.engine``, whose ``__init__`` imports the engines,
which import the kernel packages back), so each case imports its module
in a new process where no ``repro_torch`` module has been imported. The
processes are children of one fork server that has imported ``torch``
and ``numpy`` and nothing of this repository, which keeps a case at a
fraction of a second instead of a whole interpreter start.
"""
import importlib
import multiprocessing
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (SRC / "repro_torch").rglob("*.py"))


@pytest.fixture(scope="module")
def ctx():
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["numpy", "torch"])
    return ctx


def test_every_module_is_listed():
    assert len(MODULES) > 60
    for must in ("repro_torch.kernels.cache_pass.ops",
                 "repro_torch.kernels.cache_pass.ref",
                 "repro_torch.core.tracegen.ref",
                 "repro_torch.serving.pool_ref",
                 "repro_torch.serving.sim.step",
                 "repro_torch.sharding",
                 "repro_torch.launch.mesh",
                 "repro_torch.models.moe",
                 "repro_torch.configs.olmoe_1b_7b",
                 "repro_torch.configs.whisper_tiny",
                 "repro_torch.configs.llama_3_2_vision_11b",
                 "repro_torch.optim.optimizer",
                 "repro_torch.data.pipeline",
                 "repro_torch.checkpoint.checkpointing",
                 "repro_torch.runtime.fault_tolerance",
                 "repro_torch.launch.dryrun",
                 "repro_torch.launch.hlo_analysis"):
        assert must in MODULES, must


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_first_in_a_fresh_process(ctx, module):
    proc = ctx.Process(target=importlib.import_module, args=(module,))
    proc.start()
    proc.join(120)
    assert proc.exitcode == 0, \
        f"import {module} failed in a fresh process (its traceback is in " \
        f"the captured stderr), exit code {proc.exitcode}"


#: run in a fresh child: import the modules of MODULES_ (a tuple of names),
#: then exit 1 if anything of JAX, of the reference package or of
#: ``ml_dtypes`` was imported (the reference's checkpoints need it for
#: bfloat16; the port reads them through torch's views)
_NO_REFERENCE = """
import importlib, sys
for m in MODULES_:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
if bad:
    print("imported:", bad[:8], file=sys.stderr)
    sys.exit(1)
"""


def _imports_no_reference(ctx, modules) -> int:
    proc = ctx.Process(target=exec, args=(
        _NO_REFERENCE.replace("MODULES_", repr(tuple(modules))),))
    proc.start()
    proc.join(120)
    return proc.exitcode


def test_sharded_sweep_modules_import_neither_jax_nor_the_reference(ctx):
    code = _imports_no_reference(ctx, (
        "repro_torch.sharding", "repro_torch.launch.mesh",
        "repro_torch.launch", "repro_torch.api"))
    assert code == 0, \
        "importing repro_torch.sharding / launch.mesh / api pulled in jax " \
        f"or repro (see the captured stderr), exit code {code}"


def test_model_modules_import_neither_jax_nor_the_reference(ctx):
    """The model zoo, every ported config and the serving engine."""
    from repro_torch.configs.base import ARCH_IDS
    code = _imports_no_reference(
        ctx, [m for m in MODULES if m.startswith("repro_torch.models")]
        + [f"repro_torch.configs.{a}" for a in ARCH_IDS]
        + ["repro_torch.serving.engine"])
    assert code == 0, \
        "importing repro_torch.models / configs / serving.engine pulled in " \
        f"jax, repro or ml_dtypes (see the captured stderr), exit code {code}"


@pytest.mark.parametrize("module", [
    "repro_torch.optim.optimizer", "repro_torch.data.pipeline",
    "repro_torch.checkpoint.checkpointing",
    "repro_torch.runtime.fault_tolerance"])
def test_training_modules_import_neither_jax_nor_the_reference(ctx, module):
    """Each training module first in a fresh process pulls in nothing of
    JAX, of the reference, or ``ml_dtypes``."""
    code = _imports_no_reference(ctx, (module,))
    assert code == 0, \
        f"importing {module} pulled in jax, repro or ml_dtypes (see the " \
        f"captured stderr), exit code {code}"


@pytest.mark.parametrize("module", ["repro_torch.launch.dryrun",
                                    "repro_torch.launch.hlo_analysis"])
def test_dry_run_modules_import_neither_jax_nor_the_reference(ctx, module):
    """The dry run and its op-stream counter first in a fresh process pull
    in nothing of JAX, of the reference, or ``ml_dtypes``."""
    code = _imports_no_reference(ctx, (module,))
    assert code == 0, \
        f"importing {module} pulled in jax, repro or ml_dtypes (see the " \
        f"captured stderr), exit code {code}"
