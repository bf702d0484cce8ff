"""Memory organization (paper Fig. 2 and §5.2).

bank(group) -> mat -> subarray; 4x4 subarrays of 256 rows x 128 cols per
mat, 4x4 mats per group; the evaluated platform is 64 MB with a 128-bit bus.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Geometry:
    rows: int = 256
    cols: int = 128
    subarrays_per_mat: int = 16      # 4x4
    mats_per_group: int = 16         # 4x4
    capacity_mb: int = 64
    bus_bits: int = 128

    @property
    def subarray_bits(self) -> int:
        return self.rows * self.cols

    @property
    def mat_bits(self) -> int:
        return self.subarray_bits * self.subarrays_per_mat

    @property
    def group_bits(self) -> int:
        return self.mat_bits * self.mats_per_group

    @property
    def capacity_bits(self) -> int:
        return self.capacity_mb * (1 << 20) * 8

    @property
    def n_groups(self) -> int:
        return max(1, self.capacity_bits // self.group_bits)

    @property
    def n_mats(self) -> int:
        return self.n_groups * self.mats_per_group

    @property
    def n_subarrays(self) -> int:
        return self.n_mats * self.subarrays_per_mat

    def with_capacity(self, capacity_mb: int) -> "Geometry":
        return dataclasses.replace(self, capacity_mb=capacity_mb)

    def with_bus(self, bus_bits: int) -> "Geometry":
        return dataclasses.replace(self, bus_bits=bus_bits)
