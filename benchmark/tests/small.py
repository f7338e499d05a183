"""Small traffic sizes for the CPU tests, one per traffic mix: the cells'
paths and checks at a size a test run holds."""

SMALL = {
    "bulk_forward": dict(rows=48, chunk_size=20),
    "bulk_forward_hands": dict(rows_per_hand=24),
    "posed_gather": dict(rows=48, subjects=12),
}
