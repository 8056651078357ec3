"""Drives: one module per entry point of the program, found by the name
a cell's file gives (`"drive"`). Each defines `Drive`, built as
`Drive(cell, seed, device, log)`, with `setup()`, `dispatch(i)`,
`resolve(handle)`, `modules()`, `work(...)`, `counters()`,
`free_program()`, `reference(prec)` and `judge(...)` (see
benchmark/identify.py)."""
