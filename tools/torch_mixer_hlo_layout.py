"""Where the reference's sharded mixers contract, read from its HLO.

The JAX package's recurrent mixers (``repro/nn/ssm.py``: the mLSTM, the
sLSTM and Mamba) carry no partitioning of their own: under a mesh GSPMD
lays each product out from the weights' specs (``repro/distributed/
sharding.py``'s rules). This tool jits the ``value_and_grad`` of one
mixer layer, ``(mixer(p, x) * w).sum()``, at the port's ``reduced()``
xlstm / jamba widths (d 64, 2 heads; B 8, T 32, the chunk 8), its
weights placed by ``param_specs`` and its input by ``batch_spec`` on a
forced 4-device CPU mesh with Auto axes, and reads the module after
XLA's ``spmd-partitioning`` pass (``--xla_dump_hlo_pass_re``): each
``dot``, each collective (with the mesh axis its groups run over) and
each op with neither, by the source line of ``repro/nn/ssm.py`` it came
from (the HLO's stack frames), forward (``jvp``) and backward
(``transpose``) apart. A site is "partial" where its sums run across
"model" (an ``all-reduce`` or ``reduce-scatter`` there: the reference
sums the ranks' partial products), else "whole" (after the
``all-to-all`` or ``all-gather`` on "model" that moved its operands
there, if one did) or "local" (no product, no collective); each dot's
contracted elements stand beside the unpartitioned module's (a weight's
gradient contracts the rank's batch block: its sum over "data" is the
data-parallel one):

    python tools/torch_mixer_hlo_layout.py [--kinds mlstm,slstm,mamba] \\
        [--meshes 2x2,1x4]

One JSON line a (mesh, mixer, site, direction); ~10 s a mixer on the
CPU. Runs the JAX package only (it needs no port).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
D, HEADS, B, T, CHUNK, D_STATE = 64, 2, 8, 32, 8, 16

# site of a source line of repro/nn/ssm.py (first match up the stack)
LINE_SITES = (
    ('p["up_proj"]', "up_proj"), ('p["in_proj"]', "in_proj"),
    ('p["wq"]', "q"), ('p["wk"]', "k"), ('p["wv"]', "v"),
    ('p["w_if"]', "gates"), ("jnp.mean(hh * hh", "moment"),
    ('p["down_proj"]', "down_proj"), ('p["w_in"]', "w_in"),
    ('p["ff_up"]', "ff_up"), ('p["ff_down"]', "ff_down"),
    ('p["x_proj"]', "x_proj"), ('p["dt_w"]', "dt_proj"),
    ('p["out_proj"]', "out_proj"), ("hs, C_", "scan_out"),
)
FUNC_SITES = {"_mlstm_chunk_parallel": "cell", "_mlstm_cell": "cell",
              "_slstm_cell": "recurrence", "causal_conv1d": "conv",
              "_ssm_combine": "scan", "_groupnorm_heads": "norm"}
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
INSTR = re.compile(r"^\s*(?:ROOT )?%(\S+) = (\([^)]*\)|\S+) ([\w-]+)\((.*?)\)"
                   r"(.*)$")
SHAPE = re.compile(r"\w+\[([\d,]*)\]")


def _tables(text: str):
    """The module's stack-frame tables -> frame id -> [(file, function,
    line)], innermost first."""
    sect, files, funcs, locs, frames = None, {}, {}, {}, {}
    for line in text.splitlines():
        s = line.strip()
        if s in ("FileNames", "FunctionNames", "FileLocations",
                 "StackFrames"):
            sect = s
            continue
        if not s or not s[0].isdigit():
            if not s:
                sect = None
            continue
        k, rest = s.split(" ", 1)
        k = int(k)
        if sect == "FileNames":
            files[k] = rest.strip('"')
        elif sect == "FunctionNames":
            funcs[k] = rest.strip('"')
        elif sect == "FileLocations":
            f = dict(re.findall(r"(\w+)=(\d+)", rest))
            locs[k] = (int(f["file_name_id"]), int(f["function_name_id"]),
                       int(f["line"]))
        elif sect == "StackFrames":
            f = dict(re.findall(r"(\w+)=(\d+)", rest))
            # the text prints a parent's id plus one (0: none)
            frames[k] = (int(f["file_location_id"]),
                         int(f.get("parent_frame_id", 1)) - 1)

    def chain(fid):
        out, seen = [], set()
        while fid in frames and fid not in seen:
            seen.add(fid)
            loc, parent = frames[fid]
            fi, fu, ln = locs[loc]
            out.append((files[fi], funcs[fu], ln))
            fid = parent
        return out
    return {fid: chain(fid) for fid in frames}


def _site(chain, src_lines) -> str | None:
    for file, func, line in chain:
        if not file.endswith("repro/nn/ssm.py"):
            continue
        text = src_lines[line - 1]
        for pat, site in LINE_SITES:
            if pat in text:
                return site
        if func in FUNC_SITES:
            return FUNC_SITES[func]
    return None


def _dims(s: str):
    m = SHAPE.search(s)
    return [int(v) for v in m.group(1).split(",") if v] if m else []


def _groups(attrs: str, n_dev: int):
    """A collective's device groups (``replica_groups`` explicit or as an
    iota ``[G,S]<=[dims]T(perm)``; a permute's source-target pairs)."""
    import numpy as np
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\]"
                  r"(?:T\(([\d,]+)\))?", attrs)
    if m:
        g, sz = int(m.group(1)), int(m.group(2))
        ids = np.arange(n_dev).reshape([int(v) for v in
                                        m.group(3).split(",")])
        if m.group(4):
            ids = ids.transpose([int(v) for v in m.group(4).split(",")])
        return [list(r) for r in ids.reshape(g, sz)]
    m = re.search(r"(?:replica_groups|source_target_pairs)=\{(.*?)\}\}",
                  attrs)
    if not m:
        return [list(range(n_dev))]
    return [[int(v) for v in grp.split(",") if v]
            for grp in re.findall(r"\{([\d,]*)", m.group(1) + "}")]


def _axis(groups, data: int, model: int) -> str:
    """The mesh axis a collective's groups run over (devices laid out
    (data, model), row-major)."""
    on_model = all(len({d // model for d in g}) == 1 for g in groups)
    on_data = all(len({d % model for d in g}) == 1 for g in groups)
    if on_model and not on_data:
        return "model"
    if on_data and not on_model:
        return "data"
    return "all"


def read_module(text: str, src_lines, data: int = 1, model: int = 1):
    """-> {(site, direction): {"k": [contracted elements of each dot],
    "coll": Counter of (collective, mesh axis, bytes)}}; a site with an
    attributed op but no dot and no collective has an empty entry."""
    chains = _tables(text)
    shapes, out = {}, collections.defaultdict(
        lambda: {"k": [], "coll": collections.Counter()})
    for line in text.splitlines():
        m = INSTR.match(line)
        if not m:
            continue
        name, shape, op, operands, attrs = m.groups()
        shapes[name] = shape
        fid = re.search(r"stack_frame_id=(\d+)", attrs)
        opn = re.search(r'op_name="([^"]*)"', attrs)
        if not fid or not opn:
            continue
        site = _site(chains.get(int(fid.group(1)), []), src_lines)
        if site is None:
            continue
        key = (site, "backward" if "transpose(" in opn.group(1)
               else "forward")
        entry = out[key]
        if op == "dot":
            lhs = operands.split(",")[0].strip().lstrip("%")
            cd = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", attrs)
            dims = _dims(shapes.get(lhs, ""))
            k = 1
            for i in (int(v) for v in cd.group(1).split(",") if v):
                k *= dims[i]
            entry["k"].append(k)
        elif op.removesuffix("-start") in COLLECTIVES:
            n = 1
            for d in _dims(shape):
                n *= d
            ax = _axis(_groups(attrs, data * model), data, model)
            entry["coll"][(op.removesuffix("-start"), ax, 4 * n)] += 1
    return out


def verdict(entry) -> str:
    """"partial" where the site's sums run across "model" (an all-reduce
    or a reduce-scatter there), else "whole" (after an all-to-all or
    all-gather on "model" where one moved the operands) or "local"."""
    model = {op for op, ax, _ in entry["coll"] if ax != "data"}
    if model & {"all-reduce", "reduce-scatter"}:
        return "partial"
    if model:
        return "whole after " + " + ".join(sorted(model))
    return "whole" if entry["k"] else "local"


def layer(kind: str):
    """One layer of ``kind`` (the JAX package's init) and its call."""
    import jax
    from repro.nn import ssm
    k = jax.random.PRNGKey(0)
    if kind == "mlstm":
        return ssm.mlstm_init(k, D, HEADS), \
            lambda p, x: ssm.mlstm_apply(p, x, HEADS, chunk=CHUNK)
    if kind == "slstm":
        return ssm.slstm_init(k, D, HEADS), \
            lambda p, x: ssm.slstm_apply(p, x, HEADS, chunk=CHUNK)
    return ssm.mamba_init(k, D, d_state=D_STATE), \
        lambda p, x: ssm.mamba_apply(p, x, d_state=D_STATE, chunk=CHUNK)


def one_case(kind: str, data: int, model: int, dump: Path):
    """Compile the case with its partitioning pass dumped under ``dump``
    -> (before, after) module texts."""
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from repro.distributed import sharding as shd
    from repro.distributed.act_sharding import use_mesh
    p, fn = layer(kind)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, T, D))
    w = jax.random.normal(jax.random.PRNGKey(2), (B, T, D))
    jm = Mesh(np.array(jax.devices()[:data * model]).reshape(data, model),
              ("data", "model"))                       # Auto axes
    specs = shd.param_specs({"mix": p}, jm, "tp")["mix"]
    put = lambda t, s: jax.device_put(t, NamedSharding(jm, s))  # noqa
    pp = jax.tree_util.tree_map(
        put, p, specs, is_leaf=lambda s: isinstance(s, PartitionSpec))
    xp = put(x, shd.batch_spec(jm, B, 2, "tp"))
    name = f"mixer_{kind}_{data}x{model}"

    def loss(p, x):
        return (fn(p, x) * w).sum()
    loss.__name__ = name
    with jm, use_mesh(jm, "tp"):
        jax.jit(jax.value_and_grad(loss, argnums=(0, 1))).lower(
            pp, xp).compile()
    got = {}
    for f in dump.iterdir():
        if f".jit_{name}." in f.name and "spmd-partitioning" in f.name:
            got["before" if "before_spmd-partitioning" in f.name
                else "after"] = f.read_text()
    return got["before"], got["after"]


def rows(kinds, meshes, dump: Path):
    src = (ROOT / "src" / "repro" / "nn" / "ssm.py").read_text().splitlines()
    for data, model in meshes:
        for kind in kinds:
            before, after = one_case(kind, data, model, dump)
            whole = read_module(before, src)
            part = read_module(after, src, data, model)
            for key in sorted(part):
                site, direction = key
                coll = part[key]["coll"]
                yield {"mesh": {"data": data, "model": model},
                       "mixer": kind, "site": site, "direction": direction,
                       "layout": verdict(part[key]),
                       "contracted": sorted(part[key]["k"]),
                       "unpartitioned": sorted(whole.get(key, {"k": []})["k"]),
                       "collectives": sorted(
                           f"{n}x {op} on {ax} {b} B"
                           for (op, ax, b), n in coll.items())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kinds", default="mlstm,slstm")
    ap.add_argument("--meshes", default="2x2,1x4")
    args = ap.parse_args(argv)
    meshes = [tuple(int(v) for v in m.split("x"))
              for m in args.meshes.split(",")]
    with tempfile.TemporaryDirectory(prefix="mixer_hlo_") as tmp:
        os.environ["XLA_FLAGS"] = (
            "--xla_force_host_platform_device_count=4 "
            f"--xla_dump_to={tmp} --xla_dump_hlo_pass_re=spmd-partitioning")
        os.environ["JAX_PLATFORMS"] = "cpu"
        sys.path.insert(0, str(ROOT / "src"))
        for row in rows(args.kinds.split(","), meshes, Path(tmp)):
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
