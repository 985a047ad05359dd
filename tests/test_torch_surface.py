"""The port does everything the JAX package does: every public top-level
name of a ``lhvi_tpu/`` module has a counterpart in the same
``lhvi_tpu_torch/`` file.

Both packages are parsed with ``ast``, neither is imported. A module's
public names are its top-level definitions (functions, classes,
assignments) whose names do not start with ``_``; a package's
``__init__.py`` also counts the names it imports from the package (its
re-exported surface). The exceptions are listed below, each with its
reason: names with no role outside JAX, TPU or GSPMD plumbing (ROADMAP.md,
"What not to port"), and one name the port keeps private.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF, PORT = REPO / "lhvi_tpu", REPO / "lhvi_tpu_torch"

# (file, name) → reason; ``name`` "*" stands for every name of the file
ALLOWED = {
    ("*", "Array"): "the jax.Array type alias; the port annotates "
                    "torch.Tensor",
    ("ops/select.py", "*"): "select_last is a compare-select that dodged a TPU "
                            "minor-axis gather; the port gathers "
                            "(potentials/library.py::select_last)",
    ("ops/dia.py", "pl_program_id"): "a Pallas program-id shim for the "
                                     "kernel's interpret mode",
    ("ops/logpot.py", "disc_slot_values"): "one-hot-matmul slot values, "
                                           "because Mosaic had no in-kernel "
                                           "gather; the kernel plan's "
                                           "disc_values does its work",
    ("fg/compile.py", "expand_params"): "kept private as _expand_params",
    ("parallel/mesh.py", "make_mesh"): "a jax.sharding.Mesh; a process "
                                       "group (init_distributed) takes its "
                                       "place",
    ("parallel/mesh.py", "replicated"): "a GSPMD NamedSharding; a rank's "
                                        "tensors are its own",
    ("parallel/mesh.py", "shard_chain_state"): "GSPMD device_put of the "
                                               "chain state; each rank "
                                               "holds its rows "
                                               "(ChainShard.rows)",
    ("parallel/mesh.py", "chain_axes"): "the mesh axes of a NamedSharding; "
                                        "a ChainShard has one group",
    ("parallel/mesh.py", "shard_map_chains"): "exists because pallas_call "
                                              "does not SPMD-partition; "
                                              "each rank launches its "
                                              "kernels",
    ("parallel/__init__.py", "make_mesh"): "see parallel/mesh.py",
    ("parallel/__init__.py", "replicated"): "see parallel/mesh.py",
    ("parallel/__init__.py", "shard_chain_state"): "see parallel/mesh.py",
}


def public_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    init = path.name == "__init__.py"
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif (init and isinstance(node, ast.ImportFrom) and node.level == 0
              and (node.module or "").split(".")[0].startswith("lhvi_tpu")):
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def _allowed(rel: str, name: str) -> bool:
    return any(k in ALLOWED for k in ((rel, name), ("*", name), (rel, "*")))


REF_FILES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", REF_FILES)
def test_every_public_name_has_a_counterpart(rel):
    port = PORT / rel
    missing = sorted(
        n for n in public_names(REF / rel)
        if not _allowed(rel, n)
        and (not port.exists() or n not in public_names(port)))
    assert not missing, f"lhvi_tpu_torch/{rel} lacks {missing}"


def test_allow_list_names_only_what_the_reference_has():
    """Each exception still names a reference name the port lacks, so the
    list cannot outlive what it excuses."""
    for (rel, name), reason in ALLOWED.items():
        assert reason
        files = REF_FILES if rel == "*" else [rel]
        ref_has = [f for f in files
                   if name == "*" or name in public_names(REF / f)]
        assert ref_has, (rel, name)
        if name != "*":
            assert any(not (PORT / f).exists()
                       or name not in public_names(PORT / f)
                       for f in ref_has), (rel, name)
