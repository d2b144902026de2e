"""The port's completeness, pinned by scans of the source (AST only; no
module of either package, and not chip_smoke.py, is imported here).

* Counterparts: every public top-level function and class of
  ``go_crdt_playground_tpu``, and every public method of its classes,
  has a counterpart in the module of the same path in
  ``go_crdt_playground_tpu_torch`` (defined, bound or imported there; a
  method defined in the class or inherited), apart from the names
  listed below: each TPU kernel entry maps to the CUDA wrapper that
  replaces it, a few helpers moved module, and the rest have no
  counterpart, each with its reason.
* Kernels: the ``file:line`` of every ``pl.pallas_call(`` in the JAX
  package is the set of ``replaces`` values in chip_smoke.py's
  ``KERNELS``, and every ``KERNELS`` entry names a ``csrc/*.cu`` that
  exists and wrappers that ``ops/cuda_*.py`` defines.

Each scan takes its roots as arguments, so the planted cases run it on
copies with a counterpart removed or a stray ``pallas_call`` added.
"""

import ast
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "go_crdt_playground_tpu")
PORT = os.path.join(REPO, "go_crdt_playground_tpu_torch")
CHIP_SMOKE = os.path.join(REPO, "chip_smoke.py")

# each TPU kernel entry of the reference (a public function that reaches
# pl.pallas_call) -> the port's wrapper that launches its CUDA kernel
KERNEL_ENTRIES = {
    "ops/pallas_merge.py:pallas_ring_round_rows":
        "ops/cuda_merge.py:ring_round_rows",
    "ops/pallas_merge.py:pallas_ring_round_rows_packed":
        "ops/cuda_merge.py:ring_round_rows_packed",
    "ops/pallas_merge.py:pallas_ring_round_rows_dotpacked":
        "ops/cuda_merge.py:ring_round_rows_dotpacked",
    "ops/pallas_merge.py:pallas_gossip_round_rows":
        "ops/cuda_merge.py:gossip_round_rows",
    "ops/pallas_merge.py:pallas_merge_pairwise_rows":
        "ops/cuda_merge.py:merge_pairwise_rows",
    "ops/pallas_merge.py:pallas_gossip_round": "ops/cuda_merge.py:gossip_round",
    "ops/pallas_merge.py:pallas_merge_pairwise":
        "ops/cuda_merge.py:merge_pairwise",
    "ops/pallas_delta.py:pallas_delta_ring_round":
        "ops/cuda_delta.py:delta_ring_round",
    "ops/pallas_delta.py:pallas_delta_ring_round_packed":
        "ops/cuda_delta.py:delta_ring_round_packed",
    "ops/pallas_delta.py:pallas_delta_ring_round_dotpacked":
        "ops/cuda_delta.py:delta_ring_round_dotpacked",
    "ops/pallas_delta.py:pallas_delta_gossip_round":
        "ops/cuda_delta.py:delta_gossip_round",
    "ops/pallas_ingest.py:pallas_ingest_rows_delta":
        "ops/cuda_ingest.py:ingest_rows_delta_fused",
    "ops/pallas_digest.py:pallas_lane_fingerprints":
        "ops/cuda_digest.py:lane_fingerprints",
    "ops/pallas_digest.py:pallas_state_group_digests":
        "ops/cuda_digest.py:state_group_digests",
}

# reference helpers whose counterpart lives in another module of the port
MOVED = {
    "ops/pallas_merge.py:pack_bits": "models/packed.py:pack_bits",
    "ops/pallas_merge.py:unpack_bits": "models/packed.py:unpack_bits",
    "ops/pallas_merge.py:packed_width": "models/packed.py:packed_width",
}

# reference names with no counterpart, each with its reason
NO_COUNTERPART = {
    "ops/pallas_merge.py:gather_rows":
        "Pallas tiling: Mosaic's 128-lane HasDot gather; the CUDA kernels "
        "index vv rows in shared or device memory",
    "ops/pallas_merge.py:row_block_layout":
        "Pallas tiling: the row grid's block shapes for BlockSpecs",
    "ops/pallas_merge.py:ring_block_specs":
        "Pallas tiling: the ring kernels' BlockSpecs and index maps",
    "ops/pallas_merge.py:ring_supported":
        "Pallas tiling: whole aligned row blocks; the CUDA ring kernels "
        "take any R",
    "ops/pallas_merge.py:ring_meta":
        "Pallas tiling: the scalar-prefetch operand of ring_block_specs",
    "parallel/mesh.py:state_sharding":
        "JAX sharding spec (NamedSharding); the port places slots itself "
        "(parallel/mesh.shard_state)",
    "parallel/meshtarget.py:state_partition_specs":
        "JAX sharding spec (PartitionSpecs of a lane-sharded state)",
    "parallel/meshtarget.py:payload_partition_specs":
        "JAX sharding spec (PartitionSpecs of a lane-sharded payload)",
    "parallel/meshtarget.py:build_mesh_ingest":
        "JAX compiled-program builder (the jitted shard_map ingest); the "
        "port's slots launch K10's based entry directly",
    "parallel/meshtarget2d.py:build_mesh2d_ingest":
        "JAX compiled-program builder (the 2-D mesh's jitted ingest)",
}


# -- the scans ----------------------------------------------------------------


class Module:
    """What one source file binds at its top level."""

    def __init__(self, root: str, rel: str):
        self.rel = rel
        with open(os.path.join(root, rel)) as f:
            self.tree = ast.parse(f.read())
        self.functions = {}   # name -> FunctionDef
        self.classes = {}     # name -> ClassDef
        self.bound = set()    # every name bound at top level
        self.imports = {}     # name -> (module rel path, name there)
        pkg = os.path.dirname(rel).replace(os.sep, ".")
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
                self.bound.add(node.name)
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                self.bound.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            self.bound.add(n.id)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.bound.add((a.asname or a.name).split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    parts = pkg.split(".") if pkg else []
                    parts = parts[:len(parts) - node.level + 1]
                    mod = ".".join(parts + ([node.module] if node.module
                                            else []))
                else:
                    mod = node.module or ""
                    mod = mod.split(".", 1)[1] if "." in mod else ""
                for a in node.names:
                    name = a.asname or a.name
                    self.bound.add(name)
                    self.imports[name] = (mod.replace(".", "/"), a.name)


class Tree:
    """Every module of one package, by path relative to its root."""

    def __init__(self, root: str):
        self.root = root
        self.modules = {}
        for dirpath, dirs, files in os.walk(root):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("build", "__pycache__"))
            for name in sorted(files):
                if name.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, name), root)
                    self.modules[rel] = Module(root, rel)

    def module(self, dotted: str):
        """The module a dotted path names (``a/b`` -> a/b.py or
        a/b/__init__.py)."""
        for rel in (f"{dotted}.py", f"{dotted}/__init__.py"):
            if rel in self.modules:
                return self.modules[rel]
        return None

    def find_class(self, mod: Module, name: str, depth: int = 0):
        """The ClassDef ``name`` names in ``mod``, through imports."""
        if name in mod.classes:
            return mod, mod.classes[name]
        if name in mod.imports and depth < 8:
            target = self.module(mod.imports[name][0])
            if target is not None:
                return self.find_class(target, mod.imports[name][1],
                                       depth + 1)
        return None

    def methods(self, mod: Module, cls: ast.ClassDef, depth: int = 0):
        """Names a class binds, its bases' included."""
        out = set()
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.add(node.name)
            elif isinstance(node, ast.Assign):
                out.update(t.id for t in node.targets
                           if isinstance(t, ast.Name))
        for base in cls.bases:
            if isinstance(base, ast.Name) and depth < 8:
                found = self.find_class(mod, base.id)
                if found is not None:
                    out |= self.methods(*found, depth + 1)
        return out


def public(name: str) -> bool:
    return not name.startswith("_")


def reference_names(tree: Tree):
    """Every public function, class and class method, as
    ``module:name`` / ``module:Class.method``."""
    out = []
    for rel, mod in sorted(tree.modules.items()):
        for name in mod.functions:
            if public(name):
                out.append(f"{rel}:{name}")
        for name, cls in mod.classes.items():
            if not public(name):
                continue
            out.append(f"{rel}:{name}")
            for node in cls.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and public(node.name):
                    out.append(f"{rel}:{name}.{node.name}")
    return out


def has_counterpart(port: Tree, key: str) -> bool:
    """``module:name`` or ``module:Class.method`` exists in the port."""
    rel, name = key.split(":")
    mod = port.modules.get(rel)
    if mod is None:
        return False
    if "." not in name:
        return name in mod.bound
    cls_name, method = name.split(".")
    found = port.find_class(mod, cls_name)
    return found is not None and method in port.methods(*found)


def missing_counterparts(ref_root: str, port_root: str):
    """The reference's public names with no counterpart and no entry in
    the lists above."""
    ref, port = Tree(ref_root), Tree(port_root)
    out = []
    for key in reference_names(ref):
        if key in NO_COUNTERPART:
            continue
        target = KERNEL_ENTRIES.get(key) or MOVED.get(key) or key
        if not has_counterpart(port, target):
            out.append(key)
    return out


def _calls_pallas(node) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == "pallas_call" for n in ast.walk(node))


def pallas_sites(ref_root: str):
    """``file:line`` (file relative to ``ops/``, as KERNELS writes it)
    of every ``pl.pallas_call(`` in the package."""
    sites = set()
    for rel, mod in Tree(ref_root).modules.items():
        for n in ast.walk(mod.tree):
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "pallas_call"
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id == "pl"):
                sites.add(f"{os.path.relpath(rel, 'ops')}:{n.lineno}")
    return sites


def kernel_entries(ref_root: str):
    """The reference's public functions that reach ``pallas_call``
    through calls within their own module."""
    out = set()
    for rel, mod in Tree(ref_root).modules.items():
        reach = {name for name, fn in mod.functions.items()
                 if _calls_pallas(fn)}
        grew = True
        while grew:
            grew = False
            for name, fn in mod.functions.items():
                if name in reach:
                    continue
                called = {n.id for n in ast.walk(fn)
                          if isinstance(n, ast.Name)}
                if called & reach:
                    reach.add(name)
                    grew = True
        out |= {f"{rel}:{name}" for name in reach if public(name)}
    return out


def chip_smoke_kernels(path: str = CHIP_SMOKE):
    """chip_smoke.py's ``KERNELS`` table, read as a literal."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "KERNELS"
                        for t in node.targets)):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no KERNELS table")


def kernel_gaps(ref_root: str, port_root: str, smoke: str = CHIP_SMOKE):
    """What the kernel scan finds wrong (empty when nothing)."""
    kernels = chip_smoke_kernels(smoke)
    gaps = []
    sites, replaced = pallas_sites(ref_root), {k[3] for k in kernels}
    gaps += [f"pallas_call at {s} replaced by no KERNELS entry"
             for s in sorted(sites - replaced)]
    gaps += [f"KERNELS replaces {s}, which is no pallas_call"
             for s in sorted(replaced - sites)]
    port = Tree(port_root)
    wrappers = set()
    for rel, mod in port.modules.items():
        if rel.startswith(os.path.join("ops", "cuda_")):
            wrappers |= set(mod.functions)
    for key, _name, src, _replaces, names in kernels:
        if not (src.startswith("csrc/") and src.endswith(".cu")
                and os.path.isfile(os.path.join(port_root, src))):
            gaps.append(f"{key}: no source {src}")
        gaps += [f"{key}: no wrapper {w} in ops/cuda_*.py"
                 for w in names if w not in wrappers]
    return gaps


# -- the tests ----------------------------------------------------------------


def test_every_public_reference_name_has_a_counterpart():
    assert missing_counterparts(REF, PORT) == []


def test_the_lists_name_only_what_they_must():
    """Each listed name is a public name of the reference; each kernel
    entry, and only a kernel entry, maps to a wrapper the port defines;
    each moved name is where the list says; each name without a
    counterpart really has none, and none of them is a kernel entry."""
    ref, port = Tree(REF), Tree(PORT)
    names = set(reference_names(ref))
    for listed in (KERNEL_ENTRIES, MOVED, NO_COUNTERPART):
        assert set(listed) <= names, set(listed) - names
    assert set(KERNEL_ENTRIES) == kernel_entries(REF)
    for target in (*KERNEL_ENTRIES.values(), *MOVED.values()):
        assert has_counterpart(port, target), target
    for key, reason in NO_COUNTERPART.items():
        assert reason and not has_counterpart(port, key), key
    assert not set(NO_COUNTERPART) & kernel_entries(REF)
    wrappers = {w for k in chip_smoke_kernels() for w in k[4]}
    assert {t.split(":")[1] for t in KERNEL_ENTRIES.values()} <= wrappers


def test_every_pallas_call_has_its_kernel():
    assert len(pallas_sites(REF)) == 8
    assert kernel_gaps(REF, PORT) == []


def _copy_tree(src: str, dst: str) -> str:
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "build", "__pycache__", "*.so", "*.json"))
    return dst


def test_a_missing_counterpart_fails_the_scan(tmp_path):
    """Take ``Node.members_vv`` out of a copy of the port: the scan
    names it, and nothing else."""
    port = _copy_tree(PORT, str(tmp_path / "port"))
    path = os.path.join(port, "net", "peer.py")
    with open(path) as f:
        src = f.read()
    assert src.count("    def members_vv(") == 1
    with open(path, "w") as f:
        f.write(src.replace("    def members_vv(", "    def _members_vv("))
    assert missing_counterparts(REF, port) == ["net/peer.py:Node.members_vv"]


def test_a_stray_pallas_call_fails_the_scan(tmp_path):
    """Add a ``pl.pallas_call(`` site to a copy of the JAX package: the
    kernel scan names its file and line."""
    ref = _copy_tree(REF, str(tmp_path / "ref"))
    path = os.path.join(ref, "ops", "pallas_digest.py")
    with open(path) as f:
        lines = f.read().splitlines()
    lines += ["", "", "def pallas_stray(x):",
              "    return pl.pallas_call(_digest_kernel, out_shape=x)(x)"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    site = f"pallas_digest.py:{len(lines)}"
    assert kernel_gaps(ref, PORT) == [
        f"pallas_call at {site} replaced by no KERNELS entry"]
    assert "ops/pallas_digest.py:pallas_stray" in kernel_entries(ref)


@pytest.mark.parametrize("drop", ["source", "wrapper"])
def test_a_kernel_without_source_or_wrapper_fails_the_scan(tmp_path, drop):
    """A KERNELS entry whose csrc file or wrapper is gone fails."""
    port = _copy_tree(PORT, str(tmp_path / "port"))
    if drop == "source":
        os.remove(os.path.join(port, "csrc", "digest.cu"))
        want = "K11: no source csrc/digest.cu"
    else:
        path = os.path.join(port, "ops", "cuda_digest.py")
        with open(path) as f:
            src = f.read()
        with open(path, "w") as f:
            f.write(src.replace("def lane_fingerprints(",
                                "def _lane_fingerprints("))
        want = "K11: no wrapper lane_fingerprints in ops/cuda_*.py"
    assert kernel_gaps(REF, port) == [want]
