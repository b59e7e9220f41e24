#!/usr/bin/env python3
"""Opt-in real-data check of the PyTorch/CUDA port: the eval harness on
real (or user-supplied) data, never a synthetic stand-in.

    python3 scripts/torch_real_data_check.py --data-dir ~/det-data \
        [cifar10 mnist784 imagenet12288 clip768] [--offline] [--steps N]

Fetches CIFAR-10 (python pickles) and/or MNIST (IDX) into ``--data-dir``,
verifies checksums, then runs the matching eval configs (cifar10,
mnist784) through the port's ``evals.run_eval`` on the card ON THE REAL
DATA and requires the reports to say ``"data": "real"``. One JSON line per
config, like the port's eval CLI.

Exit codes: 0 when every report is real data with a sane angle, 1 for an
accuracy (or provenance) failure, 2 for an unknown config name, 3 when the
data cannot be had (no network egress, a missing file under ``--offline``).
``--offline`` never fetches: it uses, and requires, what is on disk (a
pre-placed ``.gz`` MNIST archive is decompressed). Already-downloaded
archives are verified and reused.

``imagenet12288`` and ``clip768`` have no public fetchable corpus: their
real-data story is ingestion of a user-supplied directory of ``.npy`` /
flat ``.bin`` row files at ``{data_dir}/{config}/`` (``data/npy_dir.py``).
Absent that directory, the script synthesizes a dataset TO DISK and runs
the same ingestion path end to end; the report then carries ``"source":
"synthesized-on-disk"`` beside the loader's ``data_source``, never posing
as the real corpus; its planted leading directions must then lie within
``PLANTED_GATE_DEG`` of the fitted span (``reference_angles_deg``). ``--device cpu`` runs the plain path (the tests do).
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tarfile
import urllib.error
import urllib.request

# runnable as `python3 scripts/torch_real_data_check.py` from anywhere
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CIFAR_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
CIFAR_MD5 = "c58f30108f718f92721af3b95e74349a"  # published on the page
# ossci-datasets is the maintained mirror of Yann LeCun's originals
MNIST_BASE = "https://ossci-datasets.s3.amazonaws.com/mnist"
MNIST_FILES = {
    # file -> md5 (the canonical values the torchvision loader pins)
    "train-images-idx3-ubyte.gz": "f68b3c2dcbeaaa9fbdd348bbdeb94873",
    "train-labels-idx1-ubyte.gz": "d53e105ee54ea40749a09fcbcd1e9432",
}

# Scale-out configs: shrunk schedules. The ingestion check reads real bytes
# through the real path and makes no throughput claim.
ROWS_CONFIGS = {
    "imagenet12288": dict(num_workers=2, rows_per_worker=256, steps=4),
    "clip768": dict(num_workers=4, rows_per_worker=256, steps=4),
}
# A synthesized corpus has a known truth: its planted leading directions
# (eigenvalues 20 down to 2.7, far above the noise floor's 1e-4) must lie
# inside the fitted span. The corpus's full top-k is not a usable truth:
# past ~35 directions the planted spectrum sinks below the noise floor.
PLANTED_LEADING = 10
PLANTED_GATE_DEG = 5.0


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fetch(url: str, dst: str, md5: str | None) -> None:
    if os.path.exists(dst) and (md5 is None or _md5(dst) == md5):
        print(f"# reusing {dst}", file=sys.stderr)
        return
    print(f"# fetching {url}", file=sys.stderr)
    tmp = dst + ".part"
    # bounded socket timeout: a blackholed egress must still reach the
    # exit-3 path instead of hanging
    with urllib.request.urlopen(url, timeout=30) as r:  # noqa: S310
        with open(tmp, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
    if md5 is not None and _md5(tmp) != md5:
        os.unlink(tmp)
        raise RuntimeError(f"checksum mismatch for {url}")
    os.replace(tmp, dst)


def prepare_cifar10(data_dir: str, offline: bool) -> str:
    """Ensure ``cifar-10-batches-py/`` exists under data_dir; return it."""
    out = os.path.join(data_dir, "cifar-10-batches-py")
    if os.path.isdir(out) and any(
        n.startswith("data_batch") for n in os.listdir(out)
    ):
        return out
    if offline:
        raise FileNotFoundError(f"{out} missing and --offline set")
    arc = os.path.join(data_dir, "cifar-10-python.tar.gz")
    _fetch(CIFAR_URL, arc, CIFAR_MD5)
    with tarfile.open(arc, "r:gz") as t:
        t.extractall(data_dir, filter="data")
    return out


def prepare_mnist(data_dir: str, offline: bool) -> str:
    """Ensure the MNIST train IDX files exist (decompressed); return dir."""
    import gzip
    import shutil

    out = os.path.join(data_dir, "mnist")
    os.makedirs(out, exist_ok=True)
    for name, md5 in MNIST_FILES.items():
        raw = os.path.join(out, name[: -len(".gz")])
        if os.path.exists(raw):
            continue
        gz = os.path.join(out, name)
        if offline:
            # decompressing an already-present archive needs no network,
            # so --offline only forbids the fetch itself
            if not os.path.exists(gz):
                raise FileNotFoundError(
                    f"{raw} (or {gz}) missing and --offline set"
                )
        else:
            # _fetch reuses a checksum-valid file and re-downloads a
            # truncated or corrupt one
            _fetch(f"{MNIST_BASE}/{name}", gz, md5)
        with gzip.open(gz, "rb") as f_in, open(raw + ".part", "wb") as f_out:
            shutil.copyfileobj(f_in, f_out)
        os.replace(raw + ".part", raw)
    return out


def planted_rows(name: str):
    """The planted subspace a synthesized ``name`` corpus is drawn from
    (the eval's ``planted_subspace``, seed 11)."""
    from distributed_eigenspaces_tpu_torch.data.synthetic import planted_subspace
    from distributed_eigenspaces_tpu_torch.evals import EVAL_SPECS

    spec = EVAL_SPECS[name]
    return planted_subspace(spec.dim, k_planted=spec.k, gap=20.0, noise=0.01, seed=11)


def prepare_rows(data_dir: str, name: str) -> tuple[str, bool]:
    """Ensure ``{data_dir}/{name}/`` holds row files; returns
    ``(config_dir_parent, synthesized)``. User-supplied files win; an empty
    or missing directory gets a synthesized-on-disk dataset (the eval's
    ``planted_subspace``, seed 11, drawn from a numpy generator)."""
    import numpy as np

    sub = os.path.join(data_dir, name)
    if os.path.isdir(sub) and any(
        f.endswith((".npy", ".bin")) for f in os.listdir(sub)
    ):
        return data_dir, False

    over = ROWS_CONFIGS[name]
    spectrum = planted_rows(name)
    d = spectrum.basis.shape[0]
    rows = over["num_workers"] * over["rows_per_worker"] * (over["steps"] + 1)
    print(f"# synthesizing {rows} x {d} rows under {sub}", file=sys.stderr)
    os.makedirs(sub, exist_ok=True)
    x = np.asarray(spectrum.sample(np.random.default_rng(11), rows), np.float32)
    half = rows // 2
    if name == "imagenet12288":
        # patch-stack form (N, 64, 64, 3): exercises the row-major flatten
        # the patch contract documents
        np.save(os.path.join(sub, "patches_000.npy"), x[:half].reshape(-1, 64, 64, 3))
        np.save(os.path.join(sub, "patches_001.npy"), x[half:].reshape(-1, 64, 64, 3))
    else:
        # one .npy + one flat .bin: both ingestion formats covered
        np.save(os.path.join(sub, "embeddings_000.npy"), x[:half])
        x[half:].tofile(os.path.join(sub, "embeddings_001.bin"))
    return data_dir, True


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("configs", nargs="*", default=[],
                   help="cifar10 / mnist784 / imagenet12288 / clip768 "
                        "(default: cifar10 mnist784)")
    p.add_argument("--data-dir", default="det-data",
                   help="where archives + extracted datasets live")
    p.add_argument("--offline", action="store_true",
                   help="never fetch; use (and require) what's on disk")
    p.add_argument("--steps", type=int, default=None,
                   help="override the config's step count (quick checks)")
    p.add_argument("--device", default="cuda",
                   help="the device to run on (default: the card)")
    args = p.parse_args(argv)

    names = args.configs or ["cifar10", "mnist784"]
    known = {"cifar10", "mnist784"} | set(ROWS_CONFIGS)
    bad = set(names) - known
    if bad:
        print(f"error: real-data configs are {sorted(known)}, got {bad}",
              file=sys.stderr)
        return 2
    os.makedirs(args.data_dir, exist_ok=True)

    prep = {"cifar10": prepare_cifar10, "mnist784": prepare_mnist}
    dirs = {}
    synthesized = {}
    for name in names:
        try:
            if name in ROWS_CONFIGS:
                dirs[name], synthesized[name] = prepare_rows(args.data_dir, name)
            else:
                dirs[name] = prep[name](args.data_dir, args.offline)
                synthesized[name] = False
        # EOFError: gzip raises it on a truncated pre-placed archive
        except (urllib.error.URLError, OSError, RuntimeError, EOFError) as e:
            print(
                f"error: could not obtain real data for {name}: {e}\n"
                "(no network egress? re-run where downloads work, or "
                "place the files under --data-dir and pass --offline)",
                file=sys.stderr,
            )
            return 3

    from distributed_eigenspaces_tpu_torch.evals import run_eval

    ok = True
    for name in names:
        over = dict(ROWS_CONFIGS.get(name, {}))
        if args.steps is not None:
            over["steps"] = args.steps
        planted = (
            {"planted_leading": planted_rows(name).basis[:, :PLANTED_LEADING]}
            if synthesized.get(name) else None
        )
        rep = run_eval(name, data_dir=dirs[name], device=args.device,
                       reference_bases=planted, **over)
        if synthesized.get(name):
            # provenance honesty: the bytes came off disk through the real
            # ingestion path, but the corpus is locally made
            rep["source"] = "synthesized-on-disk"
        print(json.dumps(rep), flush=True)
        if rep["data"] != "real":
            # the whole point of this script: never silently fall back
            print(f"error: {name} fell back to synthetic data "
                  f"(dir: {dirs[name]})", file=sys.stderr)
            ok = False
        if name in ROWS_CONFIGS and "data_source" not in rep:
            print(f"error: {name} report lacks data_source provenance",
                  file=sys.stderr)
            ok = False
        # real-data gate: uncentered real covariances are dominated by the
        # mean direction, so the planted-subspace 1 degree gate does not
        # apply; require a finite sane angle instead
        if not (0.0 <= rep["principal_angle_deg"] <= 90.0):
            ok = False
        if planted and not (
            rep["reference_angles_deg"]["planted_leading"] <= PLANTED_GATE_DEG
        ):
            print(f"error: {name}: the planted leading {PLANTED_LEADING} "
                  f"directions lie {rep['reference_angles_deg']['planted_leading']}"
                  f" deg outside the fit (gate {PLANTED_GATE_DEG})", file=sys.stderr)
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
