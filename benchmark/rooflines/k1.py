"""K1, the fused reconstruct (`cuda_kernels.reconstruct_picture`): the
least device-memory traffic of one picture, a frozen copy of
`reconstruct_bound`: each input byte read once and each output byte
written once.  256 B of coefficients a coded block, 64 B of prediction a
block that is not coded intra, 60 B of plan a macroblock, and a written
frame of total_size bytes with its pad read from the current frame.  The
integer work (~600 ops an IDCT block) is far below the card's rate, so
bytes bound it."""

KERNELS = ("reconstruct_kernel",)


def picture_bytes(counts, geom: dict) -> int:
    """`counts`: [coded blocks, predicted blocks, main, escapes]."""
    coded, predicted = int(counts[0]), int(counts[1])
    frame = geom["total_size"] + (geom["total_size"] - geom["frame_size"])
    return 256 * coded + 64 * predicted + 60 * geom["mb_size"] + frame
