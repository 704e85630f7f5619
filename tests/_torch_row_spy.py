"""A model API that records what a ``Server`` hands ``prefill_step``,
beside what the Server's own state says at that moment: the slots in
their prefill phase, their positions and their page-table rows.

Construct the Server with the spy as its API, then set ``spy.server``
before the first tick."""

import numpy as np


class PrefillRowSpy:
    def __init__(self, api):
        self._api = api
        self.server = None
        self.calls: list[dict] = []

    def __getattr__(self, name):
        return getattr(self._api, name)

    def prefill_step(self, params, state, tokens, positions, lengths=None,
                     page_table=None):
        srv = self.server
        live = [s for s in range(srv.batch) if srv.slot_req[s] is not None]
        prefilling = [s for s in live if srv._phase(s) == "prefill"]
        self.calls.append(dict(
            rows=int(tokens.shape[0]), prefilling=prefilling,
            decoding=len(live) - len(prefilling),
            positions=positions.cpu().numpy().copy(),
            lengths=lengths.cpu().numpy().copy(),
            page_table=(None if page_table is None
                        else page_table.cpu().numpy().copy()),
            want_positions=srv.slot_pos[prefilling].copy(),
            want_page_table=(None if srv.alloc is None
                             else srv.alloc.page_table[prefilling].copy())))
        return self._api.prefill_step(params, state, tokens, positions,
                                      lengths, page_table)

    def assert_prefilling_rows_only(self) -> None:
        """Every step got exactly the prefilling slots' rows, in slot
        order, each with chunk tokens to write."""

        assert self.calls
        for c in self.calls:
            assert c["rows"] == len(c["prefilling"]) >= 1
            np.testing.assert_array_equal(c["positions"],
                                          c["want_positions"])
            np.testing.assert_array_equal(c["page_table"],
                                          c["want_page_table"])
            assert (c["lengths"] > 0).all()

    def assert_whole_batch(self) -> None:
        """Every step got every slot's row, the idle and decoding ones
        at length 0."""

        assert self.calls
        for c in self.calls:
            assert c["rows"] == self.server.batch
            assert np.flatnonzero(c["lengths"]).tolist() == c["prefilling"]
            np.testing.assert_array_equal(
                c["positions"][c["prefilling"]], c["want_positions"])
