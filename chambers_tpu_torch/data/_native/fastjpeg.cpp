// Native batch JPEG decode for the host input pipeline (the port's copy of
// chambers_tpu/data/_native/fastjpeg.cpp): libjpeg(-turbo) decode with a
// pthread worker pool, exposed through a plain C ABI consumed via ctypes.
//
// Two-phase contract (the caller owns all memory):
//   cj_jpeg_dims(path, &h, &w)          -> probe dimensions from the header
//   cj_decode_into(path, buf)           -> decode RGB8 into caller buffer
//   cj_decode_batch(paths, bufs, n, t)  -> pool of t threads over n files
//
// Returns 0 on success, negative error codes otherwise. Decodes to RGB
// (grayscale sources are expanded by libjpeg); EXIF orientation is
// deliberately ignored, matching the Python paths (PIL without exif
// transpose, cv2 IMREAD_IGNORE_ORIENTATION) and tf.io.decode_jpeg.

#include <atomic>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <pthread.h>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
    ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
    longjmp(err->jump, 1);
}

void silence_output(j_common_ptr, int) {}

struct FileBytes {
    std::vector<unsigned char> data;
    bool ok = false;
};

FileBytes read_file(const char* path) {
    FileBytes out;
    FILE* f = std::fopen(path, "rb");
    if (!f) return out;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    if (size <= 0) { std::fclose(f); return out; }
    std::fseek(f, 0, SEEK_SET);
    out.data.resize(static_cast<size_t>(size));
    out.ok = std::fread(out.data.data(), 1, out.data.size(), f)
        == out.data.size();
    std::fclose(f);
    return out;
}

}  // namespace

extern "C" {

// -1 open/read failure, -2 not decodable as JPEG
int cj_jpeg_dims(const char* path, int* height, int* width) {
    FileBytes bytes = read_file(path);
    if (!bytes.ok) return -1;

    jpeg_decompress_struct cinfo;
    ErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    jerr.pub.emit_message = silence_output;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, bytes.data.data(),
                 static_cast<unsigned long>(bytes.data.size()));
    jpeg_read_header(&cinfo, TRUE);
    *height = static_cast<int>(cinfo.image_height);
    *width = static_cast<int>(cinfo.image_width);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// out must hold height*width*3 bytes (RGB8, HWC). -3 = dims changed between
// the probe and the decode (file mutated underneath us). fast_dct selects
// libjpeg's JDCT_IFAST (what tf.io.decode_jpeg defaults to) over the
// default JDCT_ISLOW (byte-identical to the PIL path).
int cj_decode_into(const char* path, unsigned char* out,
                   int expected_h, int expected_w, int fast_dct) {
    FileBytes bytes = read_file(path);
    if (!bytes.ok) return -1;

    jpeg_decompress_struct cinfo;
    ErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    jerr.pub.emit_message = silence_output;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, bytes.data.data(),
                 static_cast<unsigned long>(bytes.data.size()));
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    if (fast_dct) cinfo.dct_method = JDCT_IFAST;
    jpeg_start_decompress(&cinfo);
    if (static_cast<int>(cinfo.output_height) != expected_h ||
        static_cast<int>(cinfo.output_width) != expected_w ||
        cinfo.output_components != 3) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return -3;
    }
    const size_t stride = static_cast<size_t>(expected_w) * 3;
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = out + stride * cinfo.output_scanline;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

namespace {

struct BatchJob {
    const char** paths;
    unsigned char** outs;
    const int* hs;
    const int* ws;
    int* results;
    int n;
    int fast_dct;
    std::atomic<int> next{0};
};

void* batch_worker(void* arg) {
    BatchJob* job = static_cast<BatchJob*>(arg);
    while (true) {
        int i = job->next.fetch_add(1);
        if (i >= job->n) break;
        job->results[i] =
            cj_decode_into(job->paths[i], job->outs[i], job->hs[i],
                           job->ws[i], job->fast_dct);
    }
    return nullptr;
}

}  // namespace

// Decode n files with a pool of n_threads workers (work-stealing counter).
// results[i] gets the per-file status; returns the number of failures.
int cj_decode_batch(const char** paths, unsigned char** outs, const int* hs,
                    const int* ws, int* results, int n, int n_threads,
                    int fast_dct) {
    BatchJob job;
    job.paths = paths;
    job.outs = outs;
    job.hs = hs;
    job.ws = ws;
    job.results = results;
    job.n = n;
    job.fast_dct = fast_dct;

    if (n_threads < 1) n_threads = 1;
    if (n_threads > n) n_threads = n;
    if (n_threads == 1) {
        batch_worker(&job);
    } else {
        std::vector<pthread_t> threads(static_cast<size_t>(n_threads));
        for (auto& t : threads) pthread_create(&t, nullptr, batch_worker, &job);
        for (auto& t : threads) pthread_join(t, nullptr);
    }
    int failures = 0;
    for (int i = 0; i < n; ++i) failures += results[i] != 0;
    return failures;
}

}  // extern "C"
