"""Per-kernel counts of operations and bytes (ENTRY, record, cost)."""
