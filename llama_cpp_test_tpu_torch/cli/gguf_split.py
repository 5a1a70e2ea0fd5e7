"""Shard and merge GGUF files (the examples/gguf-split analogue).

Counterpart of llama_cpp_test_tpu/cli/gguf_split.py, host only:

  split: python -m llama_cpp_test_tpu_torch.cli.gguf_split \\
             --split-max-tensors 128 in.gguf out     (or --split-max-size 4G)
  merge: python -m llama_cpp_test_tpu_torch.cli.gguf_split --merge \\
             in-00001-of-00003.gguf out.gguf

Shards are named <prefix>-%05d-of-%05d.gguf (llama_split_path). The
first carries the whole metadata; every shard carries the split.* keys
and a run of the tensors. The loader reads a split model through
gguf.reader.open_gguf.
"""
from __future__ import annotations

import argparse
import re
import sys

from ..gguf.reader import SPLIT_RE, GGUFReader, split_path
from ..gguf.writer import GGUFWriter

KEY_SPLIT_NO = "split.no"
KEY_SPLIT_COUNT = "split.count"
KEY_SPLIT_TENSORS = "split.tensors.count"


def _parse_size(s: str) -> int:
    m = re.fullmatch(r"(\d+)([MG]?)", s)
    if not m:
        raise ValueError(f"bad size {s!r} (use e.g. 500M, 4G)")
    return int(m.group(1)) * {"": 1, "M": 1 << 20, "G": 1 << 30}[m.group(2)]


def split(in_path: str, out_prefix: str, max_tensors: int = 0,
          max_size: int = 0) -> list[str]:
    """in_path cut into shards of at most max_tensors tensors or max_size
    bytes each (a tensor larger than max_size gets a shard of its own);
    returns the shards' paths."""
    with GGUFReader(in_path) as r:
        names = list(r.tensors)
        groups: list[list[str]] = [[]]
        acc = 0
        for name in names:
            nbytes = r.tensors[name].nbytes
            cur = groups[-1]
            over_t = max_tensors and len(cur) >= max_tensors
            over_s = max_size and cur and acc + nbytes > max_size
            if over_t or over_s:
                groups.append([])
                acc = 0
            groups[-1].append(name)
            acc += nbytes
        paths = []
        for i, group in enumerate(groups):
            path = split_path(out_prefix, i + 1, len(groups))
            w = GGUFWriter(path)
            if i == 0:
                for k, v in r.metadata.items():
                    w.add_kv(k, v)
            w.add_kv(KEY_SPLIT_NO, i)
            w.add_kv(KEY_SPLIT_COUNT, len(groups))
            w.add_kv(KEY_SPLIT_TENSORS, len(names))
            for name in group:
                info = r.tensors[name]
                w.add_tensor(name, r.tensor_bytes(name),
                             ggml_type=info.ggml_type,
                             raw_ggml_shape=info.shape)
            w.write()
            paths.append(path)
            print(f"wrote {path} ({len(group)} tensors)")
    return paths


def merge(first_split: str, out_path: str) -> None:
    """The shards of first_split (its -00001-of-NNNNN.gguf) into one file,
    without the split.* keys."""
    m = SPLIT_RE.search(first_split)
    if not m:
        raise ValueError("input must be the first *-00001-of-NNNNN.gguf file")
    prefix = first_split[: m.start()]
    n_split = int(m.group(2))
    w = GGUFWriter(out_path)
    readers = [GGUFReader(split_path(prefix, i + 1, n_split))
               for i in range(n_split)]
    try:
        for k, v in readers[0].metadata.items():
            if not k.startswith("split."):
                w.add_kv(k, v)
        for r in readers:
            for name, info in r.tensors.items():
                w.add_tensor(name, r.tensor_bytes(name),
                             ggml_type=info.ggml_type,
                             raw_ggml_shape=info.shape)
        w.write()
    finally:
        for r in readers:
            r.close()
    print(f"merged {n_split} shards -> {out_path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("gguf-split (cuda port, host only)")
    ap.add_argument("--split-max-tensors", type=int, default=0)
    ap.add_argument("--split-max-size", default=None, help="e.g. 500M, 4G")
    ap.add_argument("--merge", action="store_true")
    ap.add_argument("input")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    if args.merge:
        merge(args.input, args.output)
    else:
        max_size = _parse_size(args.split_max_size) \
            if args.split_max_size else 0
        if not max_size and not args.split_max_tensors:
            args.split_max_tensors = 128
        split(args.input, args.output, args.split_max_tensors, max_size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
