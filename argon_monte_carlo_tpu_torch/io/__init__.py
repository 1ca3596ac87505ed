"""The port's user-facing files: the reference-format artifacts
(``writers``), checkpoints with exact resume (``checkpoint``) and the
per-epoch JSONL metrics (``metrics``).  None of them needs pandas or
matplotlib."""
