"""`python -m biem_helmholtz_sphere_tpu_torch` runs the CLI (reference:
src/biem_helmholtz_sphere/__main__.py:1-5)."""

from .cli import main

if __name__ == "__main__":
    main()
