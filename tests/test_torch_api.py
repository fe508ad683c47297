"""Every public function, method and parameter of the JAX package has its
counterpart in the port, or stands in one of the lists below with its
reason.

Both packages are parsed from their source files with `ast`; nothing of
either is imported.  ``diskann_tpu/<path>.py`` maps to
``diskann_tpu_torch/<path>.py``.  Public: a module-level function or
class whose name has no leading underscore, and the methods of such a
class that have none (dunders included).  A parameter has its counterpart
when the port's signature names it.  Every list entry must still point at
something the JAX package has and the port lacks (or renames), so a list
that goes stale fails too.
"""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PLAIN = "renamed: the port's plain torch version of the kernel is `*_plain`"
_KEY = "renamed: a JAX PRNG key is a torch.Generator (`generator`) in the port"
_MESH = ("renamed: the mesh's \"shard\" axis becomes `shards`, a shard count or one "
         "device per shard")

# (module, name) -> the port's name
RENAMED = {
    ("ops/kernels/fatrow_expand.py", "fatrow_expand_ref"): ("fatrow_expand_plain", _PLAIN),
    ("ops/kernels/block_patch.py", "block_patch_ref"): ("block_patch_plain", _PLAIN),
}

# (module, name, JAX parameter) -> (the port's parameter, reason)
RENAMED_PARAMS = {
    ("parallel/sharded.py", "ShardedGraphIndex.__init__", "mesh"): ("shards", _MESH),
    ("parallel/sharded.py", "sharded_flat_search", "mesh"): ("shards", _MESH),
    ("parallel/sharded.py", "ShardedGraphIndex.load", "mesh"): (
        "device", "renamed: the mesh a record loads onto becomes `device`, one device "
                  "or one per shard"),
    ("quant/kmeans.py", "kmeans_pp_init", "key"): ("generator", _KEY),
    ("quant/kmeans.py", "kmeans", "key"): ("generator", _KEY),
    ("quant/pq.py", "train_pq", "key"): ("generator", _KEY),
    ("quant/spherical.py", "train_spherical", "key"): ("generator", _KEY),
    ("quant/transforms.py", "train_randomized_hadamard", "key"): ("generator", _KEY),
}

# (module, name, parameter) -> the port's function that takes it through
# the signature's **kwargs
FORWARDED = {
    ("graph/index.py", "GraphIndex.build", "dtype"): "GraphIndex.__init__",
}

_DNP = "ROADMAP \"Do not port\": "
# (module, name, parameter or None for the whole function) -> reason
EXCLUDED = {
    ("graph/search.py", "beam_search_scored", "unroll"):
        _DNP + "unrolls the jitted hop loop, an XLA workaround",
    ("ops/kernels/fatrow_expand.py", "fatrow_expand", "interpret"):
        _DNP + "Pallas interpret mode; a CPU tensor runs the plain version",
    ("ops/kernels/block_patch.py", "block_patch", "interpret"):
        _DNP + "Pallas interpret mode; a CPU tensor runs the plain version",
    ("ops/kernels/fatrow_expand.py", "fatrow_expand", "block_rows"):
        _DNP + "the Pallas grid's rows per block; the CUDA kernel sets its own launch shape",
    ("graph/index.py", "GraphIndex._spill_device_state", None):
        _DNP + "spills device state to the host to defragment TPU memory",
    ("graph/index.py", "GraphIndex._restore_device_state", None):
        _DNP + "the inverse of _spill_device_state",
    ("bench/runbook.py", "RunbookExecutor.__init__", "exact_checkpoints"):
        _DNP + "the reference never reads it",
    ("graph/build.py", "insert_batch", "pool_capacity"):
        "memory: the pool's ceiling is fixed at the reference's default (512) and the "
        "pool sized from the hop cap below it",
    ("graph/build.py", "insert_batch", "prune_chunk"):
        "memory: the prune's row chunk follows from its memory budget (the reference's "
        "default 0, which every caller passes)",
    ("graph/delete.py", "patch_rows", "prune_chunk"):
        "memory: the prune's row chunk follows from its memory budget (the reference's "
        "default 0, which every caller passes)",
    ("graph/build.py", "chunked_robust_prune", "mem_budget_bytes"):
        "memory: the prune's budget is the module constant _PRUNE_MEM_BUDGET",
    ("graph/scorers.py", "packed_router_starts", "exact"):
        "the router's top-k is always exact; exact=False takes approx_min_k, a TPU "
        "speed path (divergence kept: exact top-k where JAX takes approx_min_k)",
    ("bench/harness.py", "make_clustered", "device"):
        "draws the data with JAX's generator on the accelerator; the port's families "
        "make theirs with numpy, the reference's device_data=False (divergence kept)",
    ("graph/search.py", "SearchState", None):
        "the jitted hop loop's carry; the port's eager loop keeps it in locals "
        "(ResumeState, what a resume needs, is ported)",
    ("trace.py", "add_event", None):
        "zero-length events no reader read; the port's counters (`count`, `wait`) "
        "record what the host does between spans",
}


def _params(fn) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += ["*" + a.vararg.arg] if a.vararg else []
    names += ["**" + a.kwarg.arg] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def _api(package: str, private: bool = False) -> dict:
    """{(module, name): parameter list, or None for a class} of the
    package's public functions, classes and methods (every one with
    ``private``)."""
    out = {}
    shown = lambda name: private or not name.startswith("_") or (  # noqa: E731
        name.startswith("__") and name.endswith("__"))
    for path in sorted((ROOT / package).rglob("*.py")):
        mod = path.relative_to(ROOT / package).as_posix()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and (private or not node.name.startswith("_")):
                out[(mod, node.name)] = _params(node)
            elif isinstance(node, ast.ClassDef) and (private or not node.name.startswith("_")):
                out[(mod, node.name)] = None
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and shown(m.name):
                        out[(mod, f"{node.name}.{m.name}")] = _params(m)
    return out


JAX, PORT = _api("diskann_tpu"), _api("diskann_tpu_torch")


def test_every_public_name_and_parameter_has_its_counterpart():
    missing = []
    for (mod, name), params in JAX.items():
        if (mod, name, None) in EXCLUDED:
            continue
        port_name = RENAMED.get((mod, name), (name,))[0]
        if (mod, port_name) not in PORT:
            missing.append(f"{mod}: {name}")
            continue
        for p in params or ():
            key = (mod, name, p)
            if key in EXCLUDED or p in PORT[(mod, port_name)]:
                continue
            if key in RENAMED_PARAMS and RENAMED_PARAMS[key][0] in PORT[(mod, port_name)]:
                continue
            if key in FORWARDED and "**kwargs" in PORT[(mod, port_name)] \
                    and p in PORT[(mod, FORWARDED[key])]:
                continue
            missing.append(f"{mod}: {name}({p}=...)")
    assert not missing, "not in the port and not listed:\n" + "\n".join(missing)


def test_every_list_entry_is_live_and_reasoned():
    every = _api("diskann_tpu", private=True)
    port = _api("diskann_tpu_torch", private=True)
    for (mod, name, p), reason in EXCLUDED.items():
        assert reason.strip(), (mod, name, p)
        assert (mod, name) in every, f"stale: JAX has no {mod}: {name}"
        if p is None:
            assert (mod, name) not in port, f"stale: the port has {mod}: {name}"
        else:
            assert p in every[(mod, name)], f"stale: JAX's {name} has no {p}"
            assert p not in port.get((mod, name), ()), f"stale: the port's {name} takes {p}"
    for (mod, name), (new, reason) in RENAMED.items():
        assert reason.strip() and (mod, name) in every and (mod, new) in port, (mod, name)
        assert (mod, name) not in port, f"stale: the port has {mod}: {name}"
    for (mod, name, p), (new, reason) in RENAMED_PARAMS.items():
        assert reason.strip() and p in every[(mod, name)], (mod, name, p)
        assert new in port[(mod, name)] and p not in port[(mod, name)], (mod, name, p)
    for (mod, name, p), callee in FORWARDED.items():
        assert p in every[(mod, name)] and p not in port[(mod, name)], (mod, name, p)
