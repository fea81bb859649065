"""Page-shipment reproduction for the ship-integrity checker.

``TrieDroppingCache`` imports a :class:`PageShipment` correctly at the
allocator level — pages mapped, refcounts balanced, payload written —
but skips re-registering the imported prefix coverage in the
destination trie.  The pool *looks* healthy (ledger and mirror both
check out) yet every later same-prefix arrival re-allocates pages it
should have deduped, silently doubling KV residency on the decode
tier.  ``allocator_model.check_ship_integrity`` must flag it.
"""
from repro_torch.serving.paged_cache import PagedCache


class TrieDroppingCache(PagedCache):
    """Shipment import that forgets the destination trie."""

    def import_slot_pages(self, slot, shipment):
        self._importing = True
        try:
            return super().import_slot_pages(slot, shipment)
        finally:
            self._importing = False

    def commit_prefix(self, slot):
        if getattr(self, "_importing", False):
            self._pending_prompt.pop(slot, None)
            return
        super().commit_prefix(slot)
