"""Three-tier page lifecycle policy: hot/cold classification and migration.

Counterpart of ``repro.paging.lifecycle`` (DESIGN.md §12). The pool layer
(:mod:`repro_torch.core.pool`) owns the lifecycle tables and their
transactions (``tier_init`` / ``tier_migrate`` / ``tier_demote`` /
``tier_promote``); this module owns the policy that drives them:

* **classification** rides the Leap trend: a stream proposes to re-home
  the pages its trend reaches just beyond the prefetch window toward its
  own shard; a page whose decayed heat has drained to ``heat_cold`` is a
  demotion victim while the uncompressed tier is over capacity;
* **hysteresis**: every tier transition stamps ``last_mig``, and a page is
  neither proposed nor demoted again for ``cooldown`` steps;
* **arbitration**: proposals are the third, lowest class of the per-NIC
  grants (:func:`repro_torch.core.pool.link_grants_sharded`).

Migration is scheduling metadata only: the bytes stay where the static
placement put them. Every function here takes and returns tensors of fixed
shape and decides in an order-independent way, so the consume scan gives
the reference's decisions exactly. :class:`PageLifecycle` is the NumPy
mirror on the host that the serving engine drives between decode steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pool import _TIER_NEVER, page_home
from repro_torch.device import cached_arange, resolve_device

I32 = torch.int32
_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class MigrationCfg:
    """Static policy knobs of the three-tier lifecycle (the reference's).

    Attributes:
      enabled:          master switch; ``False`` (or ``None`` for the whole
                        config) is the exact two-tier path.
      mig_per_stream:   migration proposals a stream a step (``M``).
      lead:             proposals target ``page + trend * (pw_max + lead +
                        j)`` for ``j < M``, just beyond the prefetch window.
      cooldown:         hysteresis window in steps after a tier transition.
      compressed:       enable the compressed cold tier (demotions).
      far_capacity:     most pages the uncompressed far tier holds;
                        required with ``compressed``.
      demote_per_step:  most demotions a step (``D``).
      decompress_delay: extra arrival steps on a prefetch of a compressed
                        page.
      heat_access:      heat added by one demand access of a page.
      heat_cold:        demotion eligibility (``heat <= heat_cold``).
    """
    enabled: bool = True
    mig_per_stream: int = 2
    lead: int = 1
    cooldown: int = 16
    compressed: bool = False
    far_capacity: int | None = None
    demote_per_step: int = 4
    decompress_delay: int = 2
    heat_access: int = 8
    heat_cold: int = 0

    def __post_init__(self):
        if self.mig_per_stream < 1:
            raise ValueError("mig_per_stream must be >= 1")
        if self.lead < 1:
            raise ValueError("lead must be >= 1")
        if self.cooldown < 1:
            raise ValueError("cooldown must be >= 1")
        if self.compressed and self.far_capacity is None:
            raise ValueError("compressed tier needs far_capacity")
        if self.demote_per_step < 1:
            raise ValueError("demote_per_step must be >= 1")
        if self.decompress_delay < 0:
            raise ValueError("decompress_delay must be >= 0")


def resolve(migration: MigrationCfg | None) -> MigrationCfg | None:
    """A disabled config is the same as ``None``: both are the exact
    two-tier path."""
    if migration is not None and not migration.enabled:
        return None
    return migration


def propose_migrations(leap: dict, pages: torch.Tensor,
                       homes_s: torch.Tensor, tier: dict, t,
                       n_pages: int, pw_max: int, cfg: MigrationCfg):
    """Next step's migration proposals from the post-step Leap trend.

    ``leap`` is the updated batched controller state, ``pages int32[S]``
    this step's demands, ``homes_s int32[S]`` each stream's shard (the
    destination), ``t`` the step clock. Returns ``(mpages, mdest, mvalid,
    mseq)``, each ``[S, M]``: valid where the stream has a nonzero trend,
    the target is in range, homed elsewhere and out of its cooldown;
    ``mseq = (t * S + s) * M + j`` is the global proposal order.
    """
    S = pages.shape[0]
    M = cfg.mig_per_stream
    dev = pages.device
    js = cached_arange(M, dev)
    step = leap["trend"]
    cand = (pages.to(I32)[:, None]
            + step[:, None] * (pw_max + cfg.lead + js)[None, :])
    in_range = (cand >= 0) & (cand < n_pages)
    p_safe = cand.clamp(0, n_pages - 1)
    pl = p_safe.long()
    cool = (t - tier["last_mig"][pl]) >= cfg.cooldown
    valid = (leap["has_trend"][:, None] & (step[:, None] != 0) & in_range
             & (tier["home"][pl] != homes_s[:, None]) & cool)
    seq = ((t * S + cached_arange(S, dev))[:, None] * M
           + js[None, :]).to(I32)
    dest = homes_s[:, None].expand(S, M).to(I32)
    return p_safe.to(I32), dest, valid, seq


def revalidate_proposals(mpages: torch.Tensor, mdest: torch.Tensor,
                         mvalid: torch.Tensor, mseq: torch.Tensor,
                         tier: dict, t, cfg: MigrationCfg):
    """Grant-phase re-check of carried proposals against the current
    tables (still cross-shard, still out of cooldown), then the lowest
    ``mseq`` wins among valid proposals for one page. Returns ``(mvalid',
    msrc)``, ``msrc`` each page's current home (the NIC its move
    occupies)."""
    pl = mpages.long()
    msrc = tier["home"][pl]
    cool = (t - tier["last_mig"][pl]) >= cfg.cooldown
    valid = mvalid & (msrc != mdest) & cool
    p = mpages.reshape(-1)
    v = valid.reshape(-1)
    s = mseq.reshape(-1)
    loses = ((p[None, :] == p[:, None]) & v[None, :]
             & (s[None, :] < s[:, None])).any(1)
    return (v & ~loses).reshape(valid.shape), msrc


def select_demotions(tier: dict, t, cfg: MigrationCfg):
    """Up to ``demote_per_step`` of the coldest eligible pages (uncompressed,
    ``heat <= heat_cold``, out of cooldown) while the uncompressed tier
    holds more than ``far_capacity``, ordered by the unique key ``heat *
    n_pages + page``. Returns ``(pages int32[D], ok bool[D])``."""
    n_pages = tier["home"].shape[0]
    D = cfg.demote_per_step
    comp, heat = tier["comp"], tier["heat"]
    dev = heat.device
    n_uncomp = (~comp).sum(dtype=I32)
    cool = (t - tier["last_mig"]) >= cfg.cooldown
    eligible = ~comp & (heat <= cfg.heat_cold) & cool
    key = torch.where(eligible, heat * n_pages + cached_arange(n_pages, dev),
                      torch.full_like(heat, _INT32_MAX))
    # stable, as jnp.argsort: ties (the ineligible pages) keep page order
    order = torch.argsort(key, stable=True)[:D]
    need = (n_uncomp - cfg.far_capacity).clamp(0, D)
    ok = (cached_arange(D, dev) < need) & eligible[order]
    return order.to(I32), ok


def static_home_map(n_pages: int, n_shards: int, placement: str,
                    device=None) -> torch.Tensor:
    """The t = 0 home table (the static placement formula)."""
    dev = resolve_device(device)
    return page_home(torch.arange(n_pages, dtype=I32, device=dev), n_pages,
                     n_shards, placement)


class PageLifecycle:
    """NumPy mirror of the lifecycle that the serving engine drives between
    decode steps: the same formulas as the consume scan (decay ``(h * 3) >>
    2``, cooldown hysteresis, coldest-first demotion). The caller
    round-trips each returned victim's cold bytes through the page codec,
    once, at demotion. :meth:`home_map` and :meth:`comp_map` hand the tables
    to the sweep as tensors on ``device``."""

    def __init__(self, n_pages: int, n_shards: int, placement: str,
                 cfg: MigrationCfg, device=None):
        self.n_pages, self.n_shards, self.cfg = n_pages, n_shards, cfg
        self.device = resolve_device(device)
        self.home = static_home_map(n_pages, n_shards, placement,
                                    "cpu").numpy().astype(np.int32)
        self.comp = np.zeros(n_pages, bool)
        self.heat = np.zeros(n_pages, np.int64)
        self.last_mig = np.full(n_pages, _TIER_NEVER, np.int64)
        self.migrations = self.demotions = self.promotions = 0
        self.t = 0

    def begin_step(self) -> None:
        self.heat = (self.heat * 3) >> 2
        self.t += 1

    def touch(self, pages) -> None:
        p = np.asarray(pages, np.int64).ravel()
        p = p[(p >= 0) & (p < self.n_pages)]
        np.add.at(self.heat, p, self.cfg.heat_access)

    def migrate_toward(self, pages, dest: int) -> int:
        """Re-home ``pages`` to shard ``dest`` (cooldown-gated); returns
        how many moved."""
        n = 0
        for p in np.asarray(pages, np.int64).ravel():
            if not 0 <= p < self.n_pages or self.home[p] == dest:
                continue
            if self.t - self.last_mig[p] < self.cfg.cooldown:
                continue
            self.home[p] = dest
            self.last_mig[p] = self.t
            n += 1
        self.migrations += n
        return n

    def promote(self, pages) -> int:
        """Clear the compressed bit of pages whose bytes just moved
        hot-ward (or were rewritten); returns how many were compressed."""
        n = 0
        for p in np.asarray(pages, np.int64).ravel():
            if 0 <= p < self.n_pages and self.comp[p]:
                self.comp[p] = False
                n += 1
        self.promotions += n
        return n

    def demote_victims(self, safe_mask: np.ndarray | None = None
                       ) -> list[int]:
        """Pick and demote this step's victims; returns their page ids.
        ``safe_mask`` (``bool[n_pages]``) narrows eligibility further."""
        cfg = self.cfg
        if not cfg.compressed:
            return []
        n_uncomp = int(np.sum(~self.comp))
        need = min(cfg.demote_per_step, max(0, n_uncomp - cfg.far_capacity))
        if need <= 0:
            return []
        eligible = (~self.comp & (self.heat <= cfg.heat_cold)
                    & (self.t - self.last_mig >= cfg.cooldown))
        if safe_mask is not None:
            eligible &= safe_mask
        cand = np.nonzero(eligible)[0]
        cand = cand[np.argsort(self.heat[cand] * self.n_pages + cand)][:need]
        self.comp[cand] = True
        self.last_mig[cand] = self.t
        self.demotions += len(cand)
        return [int(p) for p in cand]

    def home_map(self) -> torch.Tensor:
        return torch.tensor(self.home, device=self.device)

    def comp_map(self) -> torch.Tensor:
        return torch.tensor(self.comp, device=self.device)

    def report(self) -> dict:
        """Residency by tier and the lifecycle counters (the serve
        report's ``residency``)."""
        return {
            "n_pages": self.n_pages,
            "uncompressed": int(np.sum(~self.comp)),
            "compressed": int(np.sum(self.comp)),
            "per_shard": [int(np.sum(self.home == g))
                          for g in range(self.n_shards)],
            "migrations": self.migrations,
            "demotions": self.demotions,
            "promotions": self.promotions,
        }
