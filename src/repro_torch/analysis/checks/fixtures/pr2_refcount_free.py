"""Allocator-discipline reproductions for the small-scope model checker.

``RefcountIgnoringAllocator`` frees a page on its first decref no matter
how many references remain — the shared-prefix free-while-referenced
class.  ``cross_region_defrag_mapping`` compacts to the lowest free
index anywhere, ignoring placement regions — the cross-region move the
stack-aware layout forbids.  ``allocator_model.explore`` must produce a
minimal counterexample trace for each.
"""
from repro_torch.serving.paged_cache import PageAllocator


class RefcountIgnoringAllocator(PageAllocator):
    """decref frees unconditionally (refcount forced to 1 first)."""

    def decref(self, page: int) -> bool:
        if page in self._refs:           # keep the unallocated-page
            self._refs[page] = 1         # ValueError path intact
        return super().decref(page)


def cross_region_defrag_mapping(alloc, placement, movable):
    """Compaction that ignores regions: lowest free index anywhere."""
    mapping = {}
    taken = set(alloc.live_pages())
    for old in sorted(movable):
        candidates = [p for p in range(old) if p not in taken]
        if candidates:
            new = min(candidates)
            mapping[old] = new
            taken.discard(old)
            taken.add(new)
    return mapping
