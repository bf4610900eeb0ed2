"""Family adapters: how the harness builds, warms up and drives one model
family of the program, and how it checks what the family served against
that family's plain reference. A configuration file names its family."""
