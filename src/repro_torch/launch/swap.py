"""Hot adapter swap: install freshly published DP-LoRA checkpoints into a
LIVE multi-tenant engine. The counterpart of `repro.launch.swap`.

The training side (`launch.service.TrainService` under `--lora-rank`)
publishes adapter-only checkpoints, the tree `{"lora": <adapters>}`, to
its `publish/` directory, each with the store's per-leaf crc32 manifest
(`checkpoint.store`). The serving side runs an `AdapterWatcher` per
(tenant, publish directory); between engine dispatches it

  1. polls `latest_verified_step` (a torn or bit-rotted publish is
     invisible: only a step whose every shard passes its checksums
     counts);
  2. compares the step's manifest with what the tenant runs: the same
     step, or the same per-leaf crcs (a re-publish of identical weights),
     means no swap;
  3. loads the tree, verified, into the engine's `adapter_template()`
     and calls `DecodeEngine.update_adapter`, which copies the leaves
     into the tenant's slot of the stacked adapter buffer (blue/green, so
     requests already decoding on the old version finish on it);
  4. reads the installed slot back off the device and compares
     `adapter_crcs` with the manifest's: the swap is confirmed bit for
     bit equal to the published checkpoint, not merely "a load
     happened".

`poll()` is synchronous and cheap when idle (a directory listing, and one
manifest read on a new step): call it from the serving loop between
`engine.step()` calls, as the serve CLI's `--watch` does.
"""
from __future__ import annotations

import dataclasses

from repro_torch.checkpoint.store import (latest_verified_step,
                                          load_checkpoint, manifest_crcs)

__all__ = ["AdapterWatcher", "SwapResult"]


@dataclasses.dataclass(frozen=True)
class SwapResult:
    """One installed publish: its checkpoint step, the tenant, and the
    tenant's new adapter version. A result exists only for a swap whose
    slot read back from the device equals the manifest bit for bit (a
    mismatch raises)."""

    step: int
    tenant: int
    version: int


class AdapterWatcher:
    """Poll one publish directory and hot-swap one tenant's adapter.

    engine: a multi-tenant `DecodeEngine`; tenant: the id whose adapter
    tracks `directory` (a training service's `<service_dir>/publish`).
    The watcher owns no thread: call `poll()` when convenient."""

    def __init__(self, engine, tenant: int, directory: str):
        self.engine = engine
        self.tenant = tenant
        self.directory = directory
        self.installed_step: int | None = None
        self._installed_crcs: list[int] | None = None
        self.stats = {"polls": 0, "swaps": 0, "skipped_unchanged": 0}

    def poll(self) -> SwapResult | None:
        """Install the newest verified publish if it differs from what the
        tenant runs; a `SwapResult`, or None when there is nothing new.
        Raises RuntimeError if the publish's manifest has no crcs (nothing
        to check the swap against), or if the installed slot reads back
        different from the manifest (a failed device write: treat it as
        fatal)."""
        self.stats["polls"] += 1
        step = latest_verified_step(self.directory)
        if step is None or step == self.installed_step:
            return None
        crcs = manifest_crcs(self.directory, step)
        if crcs is None:
            raise RuntimeError(
                f"publish step {step} in {self.directory} has no per-leaf "
                f"crc32s: a hot swap could not be checked bit for bit")
        if crcs == self._installed_crcs:
            # a re-publish of identical weights: remember the step, and
            # spend no adapter slot on a blue/green rotation to itself
            self.installed_step = step
            self.stats["skipped_unchanged"] += 1
            return None
        # the service publishes the tree {"lora": <adapters>}
        template = {"lora": self.engine.adapter_template()}
        tree = load_checkpoint(self.directory, step, template, verify=True)
        self.engine.update_adapter(self.tenant, tree["lora"])
        if self.engine.adapter_crcs(self.tenant) != crcs:
            raise RuntimeError(
                f"hot swap of tenant {self.tenant} to step {step} is not "
                f"bitwise equal to the published checkpoint "
                f"({self.directory}): device readback crc mismatch")
        self.installed_step = step
        self._installed_crcs = crcs
        self.stats["swaps"] += 1
        return SwapResult(step=step, tenant=self.tenant,
                          version=self.engine.tenant_stats(
                              self.tenant)["version"])
