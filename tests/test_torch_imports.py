"""PyTorch port: import hygiene and the chip smoke's refusals.

Every module of ``tensorflow_distributed_tpu_torch`` and ``chip_smoke.py``
imports with JAX (``jax*``, ``flax``, ``optax``), ``msgpack`` (the
checkpoint codec is the port's own) and the JAX package
(``tensorflow_distributed_tpu``, not the ``_torch`` port) poisoned —
the pattern of tests/test_contracts.py's jax-free proof. The smoke exits
non-zero with no result line where there is no GPU, and where it stands
alone without the port's package.
"""

import os
import shutil
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_without_jax():
    code = textwrap.dedent("""
        import builtins, importlib, importlib.util, pkgutil
        real = builtins.__import__
        BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack",
                  "tensorflow_distributed_tpu")
        def guard(name, *a, **k):
            root = name.split(".")[0]
            if root in BANNED:
                raise ModuleNotFoundError(f"No module named {name!r}",
                                          name=name)
            return real(name, *a, **k)
        builtins.__import__ = guard
        import tensorflow_distributed_tpu_torch as port
        names = [m.name for m in pkgutil.walk_packages(
            port.__path__, port.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", "chip_smoke.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        import sys
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in BANNED)
        assert not leaked, leaked
        print("OK", len(names), *names)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")
    # Every module of the port: config, cli, interop, models (the CNN
    # included), ops (the fused-CE modules included), parallel
    # (ring_attention and mesh), data (MNIST and the prefetcher
    # included), train (the checkpoints included), utils (the msgpack
    # codec included), serve (the paged cache's pool, radix cache and
    # engine included; the journal and resilience/ with the bad-step
    # policies, and train/preemption.py: the port keeps its own copies of
    # the jax-free JAX modules, observe/anomaly.py's spike detector
    # included; PR 17's families and data: models.resnet, the CIFAR and
    # uint8 data, and the native runtime's binding; the pipeline:
    # parallel.pipeline, models.pipelined, train.pipeline_step; local
    # SGD: train.local_sgd; tensor-parallel serving and restarts:
    # serve.tp_replica, utils.atomicio, resilience.supervisor; the serve
    # observatory and the fleet: observe.*, fleet.*).
    words = out.stdout.split()
    assert int(words[1]) >= 50
    for name in ("parallel.mesh", "models.cnn", "data.mnist",
                 "data.prefetch", "utils.serialization", "train.checkpoint",
                 "serve.paging", "serve.paging.pool", "serve.paging.radix",
                 "serve.paging.engine", "serve.journal", "resilience",
                 "resilience.faults", "resilience.watchdog",
                 "resilience.policies", "train.preemption", "train.loop",
                 "train.step", "train.checkpoint", "data.prefetch", "cli",
                 "config", "serve.engine", "models.resnet", "data.cifar",
                 "data.u8", "data.lm", "native", "native.runtime",
                 "parallel.pipeline", "models.pipelined",
                 "train.pipeline_step", "train.local_sgd",
                 "serve.tp_replica", "utils.atomicio",
                 "resilience.supervisor", "observe", "observe.registry",
                 "observe.slo", "observe.trace", "observe.serve_trace",
                 "observe.anomaly", "observe.hub", "fleet", "fleet.replica",
                 "fleet.router", "fleet.controller", "fleet.run"):
        assert f"tensorflow_distributed_tpu_torch.{name}" in words[2:]


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_a_gpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "FAILED" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
