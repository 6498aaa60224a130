"""The port's streamlit app (``streamlit_app.py``)."""
