"""The binning layer's kernels by name, and the least work of its sort,
counted by the benchmark from its own grid and splat capacity, never from
what the program made.

A step bins every slot of its intersection budget: K1 writes one
(tile, gauss) key a slot, a radix sort orders them, K2 reads them back.
The narrowest key that holds both fields has a tile field for the grid's
tiles and one more (the slots past the kept total) and a gauss field for
the capacity's splats, in the smallest unsigned width of 1, 2, 4 or 8
bytes: 4 bytes at 1920x1080 and 3840x2160 up to 131,072 splats. A sort
reads and writes each slot's key once, at the least.
"""

from __future__ import annotations

from benchmark.harness import work

# name parts of the binning's device operations in a trace: K1, the
# radix sort's kernels (cub's, which torch.sort launches) and K2
K1, SORT, K2 = "fill_keys_kernel", "DeviceRadixSort", "rank_cap_kernel"


def kernel_seconds(trace, parts: tuple) -> float:
    """Device seconds of a trace's operations whose names hold one of `parts`."""
    return sum(sum(ds) for name, ds in trace.kernels.items()
               if any(p in name for p in parts))


def key_bits(num_tiles: int, capacity: int) -> int:
    """Bits of a (tile, gauss) key: tiles 0 .. num_tiles, splats 0 .. capacity - 1."""
    return int(num_tiles).bit_length() + max(int(capacity) - 1, 1).bit_length()


def key_bytes(num_tiles: int, capacity: int) -> int:
    """The narrowest unsigned key, in bytes, that holds both fields."""
    bits = key_bits(num_tiles, capacity)
    return next(b for b in (1, 2, 4, 8) if 8 * b >= bits)


def sort_bytes(slots: int, num_tiles: int, capacity: int) -> float:
    """The bytes a sort of `slots` keys moves at the least: each key read
    and written once."""
    return 2.0 * slots * key_bytes(num_tiles, capacity)


def sort_roofline_s(slots: int, num_tiles: int, capacity: int) -> float:
    """The least seconds the card could take to sort `slots` keys."""
    return work.roofline_s(sort_bytes(slots, num_tiles, capacity), 0.0)
