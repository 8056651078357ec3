"""Work counts from shapes: FLOPs per model forward (`models`) and the
bytes and operations each hand-written kernel call needs (`kernels`),
with the published peaks they are divided by (`peaks`)."""
