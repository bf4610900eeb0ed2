"""The program's kernels by their names in the device trace."""


def is_sspnna_fused(name: str) -> bool:
    """``csrc/sspnna_fused.cu``'s instantiations of the shared tile body:
    ``sspnna::tile_kernel<float, N, (anonymous namespace)::FusedRows>``."""
    return "tile_kernel" in name and "FusedRows" in name


def is_flash_bf16(name: str) -> bool:
    """``csrc/flash_fwd.cu``'s bf16 kernel, ``flash_fwd_bf16<D>``."""
    return "flash_fwd_bf16" in name
