"""Allocation and QoE operators."""
