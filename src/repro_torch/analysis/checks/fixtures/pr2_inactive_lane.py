"""Inactive-lane reproduction (AST fixture, never executed).

The engine hands block tables to the paged flash-decode kernel without
first routing *inactive* lanes' rows to the scratch page.  Every lane
writes its K/V, so a parked slot's stale table — possibly pointing at
refcounted shared pages — gets corrupted.
``kernel_lint.check_inactive_lane_ast`` must flag this function.
"""


def _decode_paged_kernel(self, toks, active):
    ki, vi = [i for i, s in enumerate(self.paged.is_seq) if s]
    store = list(self.paged.store)
    lengths = self._tensor(active.astype("int32"))
    # BUG: no torch.where(act[:, None], tables, num_pages) scratch
    # route — parked slots' stale rows go straight to the kernel
    tables = self.paged.tables_device()
    logits, _ = self.entry.module.decode_step_paged(
        self.params, self.cfg, toks, store[ki], store[vi], tables, lengths,
        tp=self.tp)
    return logits
