"""Allocation, QoE, viewport geometry and head-orientation operators."""
