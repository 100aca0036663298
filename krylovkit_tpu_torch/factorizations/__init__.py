"""Krylov factorization state and expansion steps."""
