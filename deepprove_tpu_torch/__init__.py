"""placeholder"""
