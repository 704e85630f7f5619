"""Share of the prompt tokens admitted in the window that the paged KV
mapped from a live slot's pages instead of prefilling them
(``Server.shared_tokens`` ÷ prompt tokens admitted)."""

LAYER = "paged KV (runtime/kv.py)"
UNIT = "%"
MOVES = "ttft_p90_ms"


def read(run):
    admitted = run.counters.get("prompt_tokens_admitted")
    if not admitted:
        return None
    return 100.0 * run.counters["shared_tokens"] / admitted
