"""y-quadrature solvers."""
