"""Three-term roofline per (arch x shape x mesh), with the H100's constants.

    compute    = FLOPs / (chips * PEAK_FLOPS_BF16)
    memory     = bytes per device / HBM_BW
    collective = collective bytes per device / NVLINK_BW

FLOPs, bytes and collective bytes come from the analytic model
(``analysis.flops``), the constants from ``launch/mesh.py``.  The dominant
term is the bottleneck; roofline fraction = useful compute time / the
largest term (how close the cell runs to its compute roof if the three
overlap perfectly).  The reference also parsed its compiled HLO's
collectives; the port compiles no HLO, so ``hlo_collective_bytes`` is the
count a caller measured a device (``chip_smoke.py``'s ``[ep]``, from
``models.moe.COLLECTIVE_BYTES``), 0 where none did.  ``remat`` is the
training step's recompute policy (``launch.dryrun --remat``); ``fsdp``,
``layout``, ``kv_bytes`` and ``seq_shard_decode`` are the analytic
model's layout options (``launch.dryrun --layout``, ``--kv-dtype``,
``--force-seq-shard``).  ``Roofline.row`` is a markdown table row under
``HEADER``."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.analysis import flops as F
from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    hlo_collective_bytes: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """The step's least time if the three terms overlap perfectly."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def usefulness(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roof achieved assuming perfect overlap:
        T_step = max(terms); fraction = useful-compute-time / T_step."""
        useful = self.model_flops / (self.chips * PEAK_FLOPS_BF16)
        return useful / max(self.bound_s, 1e-30)

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.compute_s:.3e} | "
                f"{self.memory_s:.3e} | {self.collective_s:.3e} | "
                f"{self.dominant} | {self.model_flops:.3e} | "
                f"{self.usefulness:.2f} | {self.roofline_fraction:.2%} |")


def analyze(cfg: ArchConfig, shape: ShapeCfg, mesh_shape: Dict[str, int],
            hlo_collective_bytes: float = 0.0, remat: str = "none",
            fsdp: bool = True, layout: str = "tp", kv_bytes: int = 2,
            seq_shard_decode: bool = False) -> Roofline:
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    m = mesh_shape.get("model", 1)
    fc = F.step_flops(cfg, shape, remat)
    bytes_dev = F.step_bytes_per_device(cfg, shape, chips, m, remat,
                                        kv_bytes, seq_shard_decode)
    coll_dev = F.collective_bytes_per_device(cfg, shape, mesh_shape, fsdp,
                                             layout)
    return Roofline(
        arch=cfg.name, shape=shape.name, chips=chips,
        compute_s=fc.hlo_flops / (chips * PEAK_FLOPS_BF16),
        memory_s=bytes_dev / HBM_BW,
        collective_s=coll_dev / NVLINK_BW,
        model_flops=fc.model_flops,
        hlo_flops=fc.hlo_flops,
        hlo_collective_bytes=hlo_collective_bytes,
    )


HEADER = ("| arch | shape | compute (s) | memory (s) | collective (s) | "
          "bottleneck | MODEL_FLOPS | useful | roofline frac |\n"
          "|---|---|---|---|---|---|---|---|---|")
