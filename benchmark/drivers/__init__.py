"""One driver per traffic kind: ``Driver(cell)`` sets a cell up, runs its
window and its traced segment, and checks what the window produced."""
