"""Attention kernels: hand-written CUDA for the card, plain PyTorch for the CPU."""


def wrappers():
    """The hand-written kernels' wrappers, by name: the ten TPU kernels'
    and the in-kernel DMA's ``hero_memcpy2d`` (core/dma.py). Each counts
    its launches in ``.launches``, in this process."""
    from repro_torch.core import dma
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import polybench as pb
    from repro_torch.kernels import tiled
    return {"paged_flash_decode": pda.paged_flash_decode,
            "paged_flash_prefill": ppa.paged_flash_prefill,
            "flash_decode": da.flash_decode,
            "flash_attention": fa.flash_attention, "gemm": gemm.gemm,
            "matvec": pb.matvec, "matvec_t": pb.matvec_t,
            "conv2d": pb.conv2d, "covar": pb.covar,
            "autodma_tiled": tiled.launch,
            "hero_memcpy2d": dma.hero_memcpy2d}
