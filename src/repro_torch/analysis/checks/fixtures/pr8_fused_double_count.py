"""Fused tick double-counting a finished lane (AST fixture, never
executed), cut from the port's ``PagedServingEngine._apply_fused`` with
the per-step emit guard removed.

The fused loop runs the padded horizon and reports which steps each lane
actually executed in ``emit_seq``: a lane that hits eos mid-horizon
keeps producing frozen tokens for the remaining steps.  Appending
without consulting the mask pushes those frozen duplicates into
``tokens_out``: the finished lane's final token is double-counted and
the fused token stream silently diverges from the per-tick engine.
``mirror_drift.check_fused_emit_guard`` must flag it.
"""


class PagedServingEngine:
    def _apply_fused(self, tok_seq, emit_seq, k, t0, t1):
        ecfg = self.ecfg
        times = [t0 + (j + 1) * (t1 - t0) / k for j in range(k)]
        finished = 0
        for slot, req in list(self.active.items()):
            last_t = t1
            for j in range(k):
                # BUG: no `if not emit_seq[j, slot]: continue` guard —
                # frozen steps of an eos'd lane are appended as if they
                # had run, double-counting its final token
                req.tokens_out.append(int(tok_seq[j, slot]))
                req.token_times.append(times[j])
                last_t = times[j]
                self._lengths_host[slot] += 1
            hit_eos = (ecfg.eos_id >= 0
                       and req.tokens_out[-1] == ecfg.eos_id)
            if hit_eos or len(req.tokens_out) >= self._budget(req):
                self._finish(slot, req, last_t, hit_eos)
                del self.active[slot]
                self._release(slot)
                finished += 1
        return finished
