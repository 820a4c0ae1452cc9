"""The host side of the kernel build (`cuvs_rag_tpu_torch/kernels/build.py`)
that needs no compiler: what `resources` reads out of a `ptxas -v` log."""

import pytest

from cuvs_rag_tpu_torch.kernels import build

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__6c2ee4a4_13_flash_attn_cu_ddac23b621flash_attn_mma_kernelILi128ELi2EEEvPK13__nv_bfloat16S3_S3_PKiPS1_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__6c2ee4a4_13_flash_attn_cu_ddac23b621flash_attn_mma_kernelILi128ELi2EEEvPK13__nv_bfloat16S3_S3_PKiPS1_iiiif
    64 bytes stack frame, 60 bytes spill stores, 56 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 64 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__522e48df_9_stream_cu_read_all18gather_rows_kernelILi32EEEvPK5uint4PKxPS1_xix' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__522e48df_9_stream_cu_read_all18gather_rows_kernelILi32EEEvPK5uint4PKxPS1_xix
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__522e48df_9_stream_cu_read_all15read_all_kernelEPK13__nv_bfloat16xiiiPf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 50 registers, used 1 barriers, 4096 bytes smem
"""


@pytest.mark.parametrize("mangled,name", [
    ("_ZN46_GLOBAL__N__6c2ee4a4_13_flash_attn_cu_ddac23b621flash_attn_mma_"
     "kernelILi128ELi2EEEvPK13__nv_bfloat16S3_S3_PKiPS1_iiiif",
     "flash_attn_mma_kernel<128,2>"),
    # a scope's hash may end in digits that read as a length: the kernel's
    # own name is the last identifier that ends in _kernel
    ("_ZN41_GLOBAL__N__522e48df_9_stream_cu_read_all23gather_rows_bulk_"
     "kernelEPKhPKxPhxxxi", "gather_rows_bulk_kernel"),
    ("_ZN41_GLOBAL__N__522e48df_9_stream_cu_read_all18gather_rows_kernel"
     "ILi32EEEvPK5uint4PKxPS1_xix", "gather_rows_kernel<32>"),
    ("_Z13pq_adc_kernelPKh", "pq_adc_kernel"),
    ("_Z6helperv", None),
])
def test_kernel_name_of_a_mangled_symbol(mangled, name):
    assert build._kernel_name(mangled) == name


def test_resources_reads_registers_spills_and_shared_memory(tmp_path,
                                                            monkeypatch):
    lib = tmp_path / "x_0123.so"
    lib.with_suffix(".log").write_text(LOG)
    monkeypatch.setattr(build, "_build", lambda source: lib)
    assert build.resources("x.cu") == {
        "flash_attn_mma_kernel<128,2>": {
            "registers": 255, "spill_store_bytes": 60, "spill_load_bytes": 56,
            "static_smem_bytes": 0},
        "gather_rows_kernel<32>": {
            "registers": 40, "spill_store_bytes": 0, "spill_load_bytes": 0,
            "static_smem_bytes": 0},
        "read_all_kernel": {
            "registers": 50, "spill_store_bytes": 0, "spill_load_bytes": 0,
            "static_smem_bytes": 4096},
    }


def test_every_entry_point_has_a_signature():
    """Each source's entry points are declared once, pointers as c_void_p
    (an undeclared pointer would be cut to 32 bits)."""
    assert set(build.SIGNATURES) == {p.name for p in build.CSRC.glob("*.cu")}
    for source, fns in build.SIGNATURES.items():
        text = (build.CSRC / source).read_text()
        for name, argtypes in fns.items():
            head = text[text.index(f"int {name}("):]
            params = head[head.index("(") + 1:head.index(")")].split(",")
            assert len(params) == len(argtypes), (source, name)
