"""K5, the window densify and metadata unpack
(`cuda_kernels.densify_unpack`): the least device-memory traffic of one
picture's share of a call, after `densify_bound`: 4 B a main record and
6 B an escape read (a nonzero coefficient is one or the other; the
blob's hop records, which carry no coefficient, are not counted), 4 B of
flags a picture and 7 B of metadata a macroblock read, 8 B a picture and
60 B a macroblock of unpacked metadata written, and 256 B of
coefficients a coded block written once.  A few integer operations a
byte: bytes bound it."""

KERNELS = ("densify_tiles_kernel", "densify_rows_kernel",
           "densify_assemble_kernel")


def picture_bytes(counts, geom: dict) -> int:
    coded, main, esc = int(counts[0]), int(counts[2]), int(counts[3])
    return 4 * main + 6 * esc + 12 + 67 * geom["mb_size"] + 256 * coded
