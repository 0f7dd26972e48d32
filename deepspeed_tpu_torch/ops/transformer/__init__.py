"""Attention operators."""
