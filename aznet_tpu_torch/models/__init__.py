"""Trunks, the AZ head and the AZ-Net module."""
