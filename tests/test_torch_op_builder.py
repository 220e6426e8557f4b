"""The port's kernel build cache (deeperspeed_tpu_torch/ops/op_builder.py):
a library's file name hashes its source, the local headers it includes
(followed into the headers) and the nvcc flags, so an edited header builds
anew instead of loading a stale library. Nothing is compiled here."""

import hashlib

from deeperspeed_tpu_torch.ops import op_builder


def test_library_path_changes_with_an_included_header(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "h.cuh"\nint f() { return 0; }\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n  #  include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// one\n")
    (tmp_path / "unused.cuh").write_text("// not included\n")
    monkeypatch.setattr(op_builder, "CSRC_DIR", tmp_path)
    assert [p.name for p in op_builder.sources("k")] == ["k.cu", "h.cuh",
                                                          "g.cuh"]
    first = op_builder.library_path("k")
    assert first == op_builder.library_path("k")
    (tmp_path / "unused.cuh").write_text("// edited, still not included\n")
    assert op_builder.library_path("k") == first
    (tmp_path / "g.cuh").write_text("// two\n")
    second = op_builder.library_path("k")
    assert second != first and second.parent == first.parent
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint f() { return 1; }\n')
    assert op_builder.library_path("k") not in (first, second)


def test_the_attention_sources_hash_their_shared_header():
    header = op_builder.CSRC_DIR / "tensor_core.cuh"
    for name in ("sparse_attention", "supertile_attention"):
        assert header in op_builder.sources(name)
    # a source with no local include keeps the name it always had: the
    # hash of its bytes and the flags
    src = op_builder.CSRC_DIR / "fused_blocks.cu"
    assert op_builder.sources("fused_blocks") == [src]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(op_builder.NVCC_FLAGS).encode())
    assert op_builder.library_path("fused_blocks").name == \
        f"libfused_blocks_{digest.hexdigest()[:16]}.so"
