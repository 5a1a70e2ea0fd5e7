"""GGUF tensor hashing (the examples/gguf-hash analogue).

Counterpart of llama_cpp_test_tpu/cli/gguf_hash.py, host only: the
sha256 of every tensor's bytes and of all of them in file order, so two
files can be compared tensor by tensor (after a quantize, split or merge);
--uuid derives a UUIDv5 from the model digest as llama.cpp does.

  python -m llama_cpp_test_tpu_torch.cli.gguf_hash [--uuid] model.gguf
"""
from __future__ import annotations

import argparse
import hashlib
import sys
import uuid


def hash_gguf(path: str, algo: str = "sha256") -> dict[str, str]:
    """name -> hex digest, and '<model>' -> the digest of all tensors."""
    from ..gguf.reader import open_gguf

    out: dict[str, str] = {}
    total = hashlib.new(algo)
    with open_gguf(path) as r:
        for name in r.tensors:
            data = r.tensor_bytes(name)
            h = hashlib.new(algo)
            h.update(data)
            total.update(data)
            out[name] = h.hexdigest()
    out["<model>"] = total.hexdigest()
    return out


# llama.cpp's namespace for model UUIDs
_UUID_NAMESPACE = uuid.UUID("ef001206-dadc-5f6d-a15f-3359e577d4e5")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("gguf-hash (cuda port, host only)")
    ap.add_argument("--sha256", action="store_true", default=True)
    ap.add_argument("--uuid", action="store_true")
    ap.add_argument("--no-per-tensor", action="store_true")
    ap.add_argument("model")
    args = ap.parse_args(argv)
    digests = hash_gguf(args.model)
    model_digest = digests.pop("<model>")
    if not args.no_per_tensor:
        for name, d in digests.items():
            print(f"sha256  {d}  {args.model}:{name}")
    print(f"sha256  {model_digest}  {args.model}")
    if args.uuid:
        print(f"UUIDv5  {uuid.uuid5(_UUID_NAMESPACE, model_digest)}  "
              f"{args.model}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
