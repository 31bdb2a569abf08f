"""Runtime fault handling: step supervision, retry, straggler stats."""
