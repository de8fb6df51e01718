"""WHDR metric and hinge loss, boundary and Lambertian losses."""
