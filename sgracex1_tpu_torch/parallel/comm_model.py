"""Communication volume of the distributed layers, as
``sgracex1_tpu.parallel.comm_model``: the exact bytes each collective
moves per layer (a property of the halo plan, not of the hardware), and a
first-order scaling prediction from them.

The link rate is an argument the caller states for the interconnect it
predicts for (NVLink, a network); no rate is built in. One card runs the
in-process mesh, whose exchange is a device copy, so no measured rate of
a link exists in this package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CommCost:
    """Bytes each shard sends over the interconnect per layer call."""

    bytes_out: float
    note: str = ""

    def seconds(self, link_bytes_s: float) -> float:
        return self.bytes_out / link_bytes_s

    def __add__(self, other: "CommCost") -> "CommCost":
        return CommCost(
            self.bytes_out + other.bytes_out,
            "+".join(n for n in (self.note, other.note) if n),
        )


def halo_comm(G, F: int, *, itemsize: int = 4, backward: bool = False) -> CommCost:
    """The boundary exchange of a ``HaloGraph``: the forward all_to_all
    ships [S, L, F] rows and each shard keeps its own block, so
    (S-1)*L*F*itemsize bytes leave a shard; the backward ships the same
    volume back."""
    S, L = G.n_shards, G.halo_len
    per_pass = (S - 1) * L * F * itemsize
    return CommCost(float(per_pass * (2 if backward else 1)), note=f"halo S={S} L={L} F={F}")


def allgather_comm(n_pad: int, F: int, S: int, *, itemsize: int = 4, backward: bool = False) -> CommCost:
    """The replicated-H layer (``spmm_dist``): each shard receives the
    other shards' rows, (S-1)/S * n_pad * F; the backward's reduce-scatter
    moves the same volume."""
    per_pass = (S - 1) / S * n_pad * F * itemsize
    return CommCost(float(per_pass * (2 if backward else 1)), note=f"all-gather n={n_pad} F={F} S={S}")


def predicted_efficiency(
    comp_sec_single: float, n_devices: int, comm: CommCost, *, link_bytes_s: float,
    overlap: float = 0.0,
) -> dict:
    """Scaling efficiency from a perfect 1/S split of the compute plus the
    collective's time, ``overlap`` of it hidden:
    efficiency = T_1 / (S * T_S), T_S = T_1/S + (1 - overlap) * T_comm."""
    t_comp = comp_sec_single / n_devices
    t_comm = comm.seconds(link_bytes_s) * (1.0 - min(max(overlap, 0.0), 1.0))
    t_step = t_comp + t_comm
    return dict(
        t_comp_us=round(t_comp * 1e6, 2),
        t_comm_us=round(t_comm * 1e6, 2),
        efficiency=round(t_comp / t_step, 4) if t_step > 0 else 1.0,
        comm_bytes=int(comm.bytes_out),
        note=comm.note,
    )


def scaling_table(comp_sec_single: float, comms: dict, *, link_bytes_s: float, overlap: float = 0.0) -> dict:
    """``{n_devices: CommCost}`` -> each count's ``predicted_efficiency``."""
    return {
        s: predicted_efficiency(comp_sec_single, s, c, link_bytes_s=link_bytes_s, overlap=overlap)
        for s, c in sorted(comms.items())
    }
