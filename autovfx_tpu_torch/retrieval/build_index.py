"""Build a precomputed Objaverse embedding index (``objaverse_index``'s
``.npz``) from asset metadata or a local asset library.

Input metadata (one or both):
  --metadata meta.json   {uid: {name, tags?, animated?, gobj_index?}}
  --scan-dir assets/     index the <name>.glb|gltf|obj|ply files of a
                         local library (uid = file stem, animated when a
                         glTF carries animation channels)

Usage:
  python -m autovfx_tpu_torch.retrieval.build_index --metadata meta.json \\
      --out _cache/objaverse_index.npz [--embedder auto|sbert|hash]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from autovfx_tpu_torch.retrieval.objaverse_index import build_index
from autovfx_tpu_torch.retrieval.wrappers import glb_has_animation


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--metadata", help="JSON {uid: {name, tags, ...}}")
    ap.add_argument("--scan-dir", help="local asset dir to index")
    ap.add_argument("--out", required=True)
    ap.add_argument("--embedder", default="auto",
                    choices=["auto", "sbert", "hash"])
    args = ap.parse_args(argv)

    entries = {}
    if args.metadata:
        with open(args.metadata) as f:
            entries.update(json.load(f))
    if args.scan_dir:
        for ext in ("glb", "gltf", "obj", "ply"):
            for p in glob.glob(os.path.join(args.scan_dir, f"**/*.{ext}"),
                               recursive=True):
                uid = os.path.splitext(os.path.basename(p))[0]
                entries.setdefault(uid, {"name": uid.replace("_", " "),
                                         "animated": glb_has_animation(p)})
    if not entries:
        ap.error("no entries: pass --metadata and/or --scan-dir")

    index = build_index(entries, out_path=args.out, embedder=args.embedder)
    print(f"wrote {args.out}: {len(index.uids)} assets, "
          f"D={index.database.shape[1]}, embedder={index.embedder}, "
          f"animated={'yes' if index.animated is not None else 'no'}")


if __name__ == "__main__":
    main()
