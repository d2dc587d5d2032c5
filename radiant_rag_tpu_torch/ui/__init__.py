"""User-facing surfaces of the port: console display, reports and the
terminal UI, copied from `radiant_rag_tpu/ui/`. Host code only; `rich` and
`textual` are optional, and without them the plain-text paths run."""
